"""Conformance: our decoder must reproduce the reference encoder's recon
bit-exactly on the committed golden bitstreams."""
import os

import numpy as np
import pytest

from xeve_jax.dec.decoder import BaselineIntraDecoder
from tests.conftest import DATA, load_rec10

CASES = [
    ("tiny_ai_q32", 64, 64, 1),
    ("s96_ai_q27", 96, 80, 2),
    ("cif_ai_q32", 352, 288, 2),
]


@pytest.mark.parametrize("name,w,h,n", CASES)
def test_decode_reference_bitstream(name, w, h, n):
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} frame {i} luma mismatch"
        assert np.array_equal(f.u, gu), f"{name} frame {i} cb mismatch"
        assert np.array_equal(f.v, gv), f"{name} frame {i} cr mismatch"


LDP_CASES = [
    ("s96_zl", 96, 80, 2),
    ("s96_zl6", 96, 80, 6),
]


@pytest.mark.parametrize("name,w,h,n", LDP_CASES)
def test_decode_reference_ldp_bitstream(name, w, h, n):
    """Low-delay P (zerolatency) streams: validates inter MC, MVP list,
    skip mode, inter cbf semantics, MV-based deblock strengths."""
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} frame {i} luma mismatch"
        assert np.array_equal(f.u, gu), f"{name} frame {i} cb mismatch"
        assert np.array_equal(f.v, gv), f"{name} frame {i} cr mismatch"


B_CASES = [
    ("s96_ldp_q30", 96, 80, 2),   # low-delay B (xeve default)
    ("s96_ldp6", 96, 80, 6),
]


@pytest.mark.parametrize("name,w,h,n", B_CASES)
def test_decode_reference_ldb_bitstream(name, w, h, n):
    """Low-delay B streams: bi-prediction, temporal-direct, L0/L1 lists."""
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} frame {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


def test_decode_reference_ra_gop16_bitstream():
    """Random-access GOP16 hierarchical-B: POC derivation from temporal ids,
    tid-constrained L0/L1 lists, DPB marking; recon compared in display
    order (the reference app dumps recon in output order)."""
    stream = open(os.path.join(DATA, "s96_ra.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == 20
    frames_disp = sorted(frames, key=lambda f: f.poc)
    for i, f in enumerate(frames_disp):
        gy, gu, gv = load_rec10(os.path.join(DATA, "s96_ra_rec.yuv"), 96, 80, i)
        assert np.array_equal(f.y, gy), f"display {i} (poc {f.poc}) luma"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


def test_picture_signature_sei_verified():
    """Decoder verifies the MD5 picture-signature SEI when present."""
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from tests.conftest import load_yuv8
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), 96, 80, 0)
    enc = Encoder(EncoderParams(w=96, h=80, qp=30, keyint=1,
                                use_pic_sign=True), coder="numpy")
    bs, _ = enc.encode_frame(y8 << 2, u8 << 2, v8 << 2)
    d = BaselineIntraDecoder()
    d.decode(bs)
    assert d.signatures_checked == 1


MAIN_MIN_CASES = [
    ("s96_mm_ai", 96, 80, 2),    # Main profile, all tools off, all-intra
    ("s96_mm_zl", 96, 80, 6),    # Main, tools off, zerolatency LD-P (dqp areas)
    ("s96_mm_ra", 96, 80, 20),   # Main, tools off, RA GOP16 hierarchical-B
]


@pytest.mark.parametrize("name,w,h,n", MAIN_MIN_CASES)
def test_decode_main_profile_minimal_tools(name, w, h, n):
    """Main-profile streams with every SPS tool disabled: pins the Main
    SPS/PPS/SH syntax (xevem_eco.c:328,436,499) and the quantization-group
    dqp coding (cu_qp_delta_area state machine, xevem.c:73-90).  Every
    picture carries a signature SEI which the decoder verifies."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


EIPD_CASES = [
    ("s96_eipd_ai", 96, 80, 2),
    ("s96_eipd_zl", 96, 80, 6),
    ("s96_eipd_ra", 96, 80, 20),
    ("cif_eipd_ai", 352, 288, 2),
]


@pytest.mark.parametrize("name,w,h,n", EIPD_CASES)
def test_decode_main_profile_eipd(name, w, h, n):
    """Main profile with EIPD: 33 luma intra modes (4-tap ADI angular,
    plane, bilinear, LUT-division DC), MPM/extended-MPM/ranked-mode
    signalling, 5-mode chroma direction (xevem_ipred.c, xevem_eco.c:1541)."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


CMI_CASES = [
    ("s96_cmi_ai", 96, 80, 2),
    ("s96_cmi_zl", 96, 80, 6),
    ("s96_cmi_ra", 96, 80, 20),
]


@pytest.mark.parametrize("name,w,h,n", CMI_CASES)
def test_decode_main_profile_cm_init(name, w, h, n):
    """Main profile with CM_INIT (+EIPD): QP/slice-type-adaptive context
    initialization (xevem_util.c:2755), neighbour-derived skip/pred-mode
    context selection, level-adaptive run/level context groups."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


ADCC_CASES = [
    ("s96_adcc_ai", 96, 80, 2),
    ("s96_adcc_zl", 96, 80, 6),
    ("s96_adcc_ra", 96, 80, 20),
    ("cif_adcc_ai", 352, 288, 2),
]


@pytest.mark.parametrize("name,w,h,n", ADCC_CASES)
def test_decode_main_profile_adcc(name, w, h, n):
    """Main profile with ADCC (+cm_init +eipd): sig-map/gtA/gtB/Golomb-Rice
    coefficient coding with template contexts and context-coded last
    position (xevem_eco.c:1042-1277, xevem_util.c:2579-2750)."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


IQT_CASES = [
    ("s96_iqt_ai", 96, 80, 2),
    ("s96_iqt_zl", 96, 80, 6),
    ("s96_iqt_ra", 96, 80, 20),
]


@pytest.mark.parametrize("name,w,h,n", IQT_CASES)
def test_decode_main_profile_iqt(name, w, h, n):
    """Main profile with IQT (+adcc+cm_init+eipd): per-stage rounded
    16-bit inverse transform, main dequant scale table, main chroma QP
    mapping incl. the deblocking path (xevem_itdq.c:551, xevem_tbl.c:53,102)."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


ATS_CASES = [
    ("s96_ats_ai", 96, 80, 2),
    ("s96_ats_zl", 96, 80, 6),
    ("s96_ats_ra", 96, 80, 20),
]


@pytest.mark.parametrize("name,w,h,n", ATS_CASES)
def test_decode_main_profile_ats(name, w, h, n):
    """Main profile with ATS: DST-7/DCT-8 intra transform pairs
    (ats_intra_cu + per-direction mode bits) and ATS-inter sub-TB
    residuals (SBT position/size signalling, zero-extended recon)
    (xevem_eco.c:908-1016, xevem_itdq.c:278, xevem_recon.c:41)."""
    dec = BaselineIntraDecoder()
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = sorted(dec.decode(stream), key=lambda f: f.poc)
    assert len(frames) == n
    assert dec.signatures_checked == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} display {i} luma mismatch"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


HTDF_CASES = [
    ("s96_htdf_ai", 96, 80, 2),
    ("s96_htdf_zl", 96, 80, 6),
    ("s96_htdf_ra", 96, 80, 20),
]


@pytest.mark.parametrize("name,w,h,n", HTDF_CASES)
def test_decode_main_profile_htdf(name, w, h, n):
    """HTDF in-loop filter streams (xevem_recon.c:277 xeve_htdf):
    validates the Hadamard-domain filter incl. its per-CU availability
    gating on intra and coefficient-bearing inter CUs."""
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    dec = BaselineIntraDecoder()
    frames = dec.decode(stream)
    assert dec.sps.tool_htdf == 1
    assert dec.signatures_checked == n
    assert len(frames) == n
    for i, f in enumerate(frames):
        # RA recon dumps are in display (poc) order
        idx = f.poc if name.endswith("_ra") else i
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h,
                                idx)
        assert np.array_equal(f.y, gy), f"{name} poc {f.poc} luma mismatch"
        assert np.array_equal(f.u, gu), f"{name} poc {f.poc} cb mismatch"
        assert np.array_equal(f.v, gv), f"{name} poc {f.poc} cr mismatch"


BTT_CASES = [
    # AI Main with BTT partitioning (binary/ternary tree, no quad;
    # xevem_mode.c mode_coding_tree_main), suco off
    ("s96_btt_ai", 96, 80, 2),
    # + SUCO at 64-CTU (right-available intra, reversed traversal)
    ("s96_bttsuco_ai", 96, 80, 2),
    # 128-CTU: sub-TB coefficient coding of >64 CUs, per-quadrant TU-edge
    # deblock, LCU-relative INTRA_STRONG bs, SUCO at 128
    ("cif_bttsuco_ai", 352, 288, 2),
]


@pytest.mark.parametrize("name,w,h,n", BTT_CASES)
def test_decode_main_profile_btt(name, w, h, n):
    """BTT split-tree decode: rectangular CUs, btt_split_flag/dir/type
    syntax with neighbour-size contexts, implicit boundary splits
    (xevem_eco.c:673, xevem_util.c:42)."""
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} frame {i} luma mismatch"
        assert np.array_equal(f.u, gu), f"{name} frame {i} cb mismatch"
        assert np.array_equal(f.v, gv), f"{name} frame {i} cr mismatch"


def test_decode_btt_suco_ld_bitstream():
    """BTT+SUCO low-delay (generalized B) stream: rect inter CUs, MVP/skip
    with suco-ordered availability, MV-aware ADDB."""
    stream = open(os.path.join(DATA, "s96_btt_ld.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == 2
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, "s96_btt_ld_rec.yuv"),
                                96, 80, i)
        assert np.array_equal(f.y, gy) and np.array_equal(f.u, gu) \
            and np.array_equal(f.v, gv), f"frame {i}"


def test_decode_btt_suco_ra_gop16_bitstream():
    """BTT+SUCO RA GOP16 Main stream (18 frames): hierarchical B with
    binary/ternary partitioning, suco inheritance through the tree
    (xevem_mode.c:1740,1815,1964), temporal direct, rect MC."""
    stream = open(os.path.join(DATA, "s96_btt_ra.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == 18
    frames = sorted(frames, key=lambda f: f.poc)
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, "s96_btt_ra_rec.yuv"),
                                96, 80, i)
        assert np.array_equal(f.y, gy) and np.array_equal(f.u, gu) \
            and np.array_equal(f.v, gv), f"frame {i} (poc {f.poc})"


def test_decode_btt_suco_ra_128ctu_bitstream():
    """BTT+SUCO RA GOP16 at CIF with the 128 CTU: inter rect CUs,
    sub-TB coefficients of >64 CUs, quadrant TU-edge deblock with MVs,
    LCU-relative INTRA_STRONG bs at 128.  Golden recon pinned by
    per-frame MD5 (display order) to keep the repo small."""
    import hashlib
    md5s = ['99fa09bc2de57a552d2426c4b2355754',
            'ebf5ddb78bb22eeaab00fcf77be51d50',
            'bd800d48609d5c758fad213d3b9619e9',
            '4a7ed3c813f3da5431c2b0f5c990dd7b',
            '8fe77f294305afd9bb016204096e0b5c',
            'a2591caaaccbf6243d10c449bcf5d4a8',
            '2c78bcd65c693f762930845dbfd5a3c9',
            '77deb15a65ee8e897c425d782203a97c',
            'ba658666654e4525dd34e1c56d775e3c',
            'a1621298f4eb9c398b3cd12268b41e09',
            'cf1ceafcd653a3a2576e237e0b7f77b0',
            '652b3adee50f3a248702b9e9a5d9e4fb',
            '25a056c9e9e261ef40be527a67876adc',
            'f639421debb27c69c44943f9b28feeaa',
            '6eb960baad54a5a0259524d94e926800',
            '93695b566e1ded7e8d903a9218db3974',
            '503791945e7125089000c09bfe6140a4',
            '43af3db85b918bbd953a32ff01ed09db']
    stream = open(os.path.join(DATA, "cif_btt_ra.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == 18
    frames = sorted(frames, key=lambda f: f.poc)
    for i, f in enumerate(frames):
        buf = (f.y.astype(np.uint16).tobytes()
               + f.u.astype(np.uint16).tobytes()
               + f.v.astype(np.uint16).tobytes())
        assert hashlib.md5(buf).hexdigest() == md5s[i], f"frame {i}"


def test_decode_mvr_idx_syntax():
    """mvr_idx (AMVR) parse validation.  The reference encoder, asked for
    tool_amvr=1 with tool_admvp=0, emits an enc/dec-INCONSISTENT stream:
    xevem_eco_unit writes mvr_idx bins from the param flag while the SPS
    (which only carries tool_amvr under tool_admvp, xevem_eco.c sps
    writer) says off — xeve_param_check normally rejects the combo
    (xevem.c:1375) but the tool-isolation driver proceeds.  Decoding with
    the flag forced pins our truncated-unary mvr_idx parse and the
    mvd << mvr_idx reconstruction ahead of the full ADMVP stack."""
    from xeve_jax.hls import SPS

    class _Dec(BaselineIntraDecoder):
        def _setup_dims(self):
            self.sps.tool_amvr = 1
            super()._setup_dims()

    stream = open(os.path.join(DATA, "s96_amvrbins_ld.evc"), "rb").read()
    frames = _Dec().decode(stream)
    assert len(frames) == 8
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA,
                                             "s96_amvrbins_ld_rec.yuv"),
                                96, 80, i)
        assert np.array_equal(f.y, gy) and np.array_equal(f.u, gu) \
            and np.array_equal(f.v, gv), f"frame {i}"
