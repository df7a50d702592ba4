"""Main-profile encoder stage 1: EIPD + CM_INIT + ADCC + IQT.

Pyramid: (a) ADCC entropy round-trip fuzz, (b) batched EIPD predictors vs
the scalar conformance kernels, (c) end-to-end Main AI encode -> own
conformance decoder bit-exact, (d) RD sanity: Main beats Baseline at equal
settings.
"""
import os

import numpy as np
import pytest

from tests.conftest import DATA, load_yuv8


def test_adcc_roundtrip_fuzz():
    from xeve_jax.entropy.sbac import SbacEncoder, SbacDecoder, SbacCtx
    from xeve_jax.entropy import adcc
    rng = np.random.RandomState(7)
    for trial in range(120):
        st = rng.randint(0, 3)
        qp = rng.randint(10, 50)
        ch = rng.randint(0, 2)
        if ch == 0:
            lw, lh = rng.randint(2, 7), rng.randint(2, 7)
        else:
            lw, lh = rng.randint(1, 6), rng.randint(1, 6)
        w, h = 1 << lw, 1 << lh
        lv = np.zeros((h, w), np.int32)
        n = rng.randint(1, max(2, w * h // 3))
        idx = rng.choice(w * h, n, replace=False)
        vals = rng.randint(1, 40, n) * rng.choice([-1, 1], n)
        vals[rng.rand(n) < 0.1] *= 50
        lv.flat[idx] = vals
        enc = SbacEncoder()
        adcc.encode_block(enc, SbacCtx(st, qp, 1), lv, ch)
        enc.encode_bin_trm(1)
        dec = SbacDecoder(enc.finish())
        out = adcc.decode_block(dec, SbacCtx(st, qp, 1), w, h, ch)
        assert np.array_equal(out, lv), (trial, w, h, ch)


def test_batched_eipd_preds_match_scalar():
    from xeve_jax.ops import intra_main_np as im
    from xeve_jax.ops import intra_main_batch as ib
    rng = np.random.RandomState(3)
    bd = 10
    for (w, h) in [(4, 4), (8, 8), (16, 16), (64, 64), (8, 4), (2, 2)]:
        up = rng.randint(0, 1024, (3, w + h + 1)).astype(np.int64)
        left = rng.randint(0, 1024, (3, h + w + 1)).astype(np.int64)
        left[:, 0] = up[:, 0]
        for ipm in range(im.IPD_CNT):
            got = ib.pred_mode_batch(up, left, ipm, w, h, bd)
            for n in range(3):
                nb = im.Nbr(up[n], left[n], im.LR_10)
                want = im.ipred_main(ipm, nb, w, h, bd)
                assert np.array_equal(got[n], want), (w, h, ipm)


def test_main_ai_roundtrip_and_rd():
    from xeve_jax.api import Encoder, psnr
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder

    y, u, v = load_yuv8(os.path.join(DATA, "s96.yuv"), 96, 80, 0)
    enc = Encoder(EncoderParams(w=96, h=80, qp=30, keyint=1, profile=1,
                                use_pic_sign=True))
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    dec = BaselineIntraDecoder()
    frames = dec.decode(bs)
    s = dec.sps
    assert (s.profile_idc, s.tool_eipd, s.tool_cm_init, s.tool_adcc,
            s.tool_iqt) == (1, 1, 1, 1, 1)
    assert dec.signatures_checked == 1
    assert np.array_equal(frames[0].y, ry)
    assert np.array_equal(frames[0].u, ru)
    assert np.array_equal(frames[0].v, rv)

    # RD: Main stage 1 must beat Baseline on this content.  With the
    # exact-rate RDO the two profiles land on different operating points
    # at equal QP, so compare as a two-QP ladder: interpolate each
    # profile's log-rate at a common PSNR (mini Bjontegaard).
    def ladder(profile):
        # second encode of the same frame: headers (SPS/PPS, bigger for
        # Main) only precede the first AU, so frame 2's bytes are pure
        # slice payload — the honest rate at this tiny frame size
        pts = []
        for qp in (27, 34):
            e = Encoder(EncoderParams(w=96, h=80, qp=qp, keyint=1,
                                      profile=profile))
            e.encode_frame(y, u, v)
            b, (r, _, _) = e.encode_frame(y, u, v)
            pts.append((np.log(len(b)), psnr(np.asarray(y, np.int32),
                                             r[:80, :96])))
        return pts

    pm, pb = ladder(1), ladder(0)

    def rate_at(pts, target_psnr):
        (lr0, p0), (lr1, p1) = pts
        t = (target_psnr - p0) / (p1 - p0)
        return lr0 + t * (lr1 - lr0)

    mid = (max(pm[1][1], pb[1][1]) + min(pm[0][1], pb[0][1])) / 2.0
    # Main stage 1 (EIPD/ADCC/ATS, no BTT yet) must be within 10% of the
    # Baseline rate at equal PSNR on this tiny clip — a gross-regression
    # guard; BTT stage 2 is what makes Main strictly better (BDRATE.md)
    assert rate_at(pm, mid) < rate_at(pb, mid) + np.log(1.10), \
        f"main ladder {pm} much worse than baseline {pb} at {mid:.2f}dB"


def test_main_native_matches_oracle():
    """Native C Main pass (EIPD+IQT+CM_INIT+ADCC) is byte-exact vs the
    numpy MainIntraFramePass."""
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    rng = np.random.RandomState(5)
    for (w, h, qp) in [(96, 80, 30), (64, 64, 22), (128, 96, 40)]:
        y = rng.randint(0, 1024, (h, w)).astype(np.int32)
        yy, xx = np.mgrid[0:h, 0:w]
        y = ((yy * 3 + xx * 2) % 900 + y // 8).clip(0, 1023)
        u = rng.randint(0, 1024, (h // 2, w // 2)).astype(np.int32)
        v = rng.randint(0, 1024, (h // 2, w // 2)).astype(np.int32)
        e1 = Encoder(EncoderParams(w=w, h=h, qp=qp, keyint=1, profile=1),
                     coder="numpy")
        e2 = Encoder(EncoderParams(w=w, h=h, qp=qp, keyint=1, profile=1,
                                   exact_rd=0), coder="native")
        b1, r1 = e1.encode_frame(y, u, v)
        b2, r2 = e2.encode_frame(y, u, v)
        assert b1 == b2
        for a, b in zip(r1, r2):
            assert np.array_equal(a, b)


def test_main_jax_analysis_agrees_with_numpy():
    """JAX 33-mode analyzer decisions == numpy oracle decisions on CPU."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.gen_test_content import gen_frame
    from xeve_jax.constants import chroma_qp_dynamic
    from xeve_jax.enc.analysis_main_np import analyze_frame_main
    from xeve_jax.enc.analysis_main_jax import analyze_frame_main_jax
    y, u, v = gen_frame(128, 64, 1)
    y = y.astype(np.int32) << 2
    u = u.astype(np.int32) << 2
    v = v.astype(np.int32) << 2
    qp = 32
    qp_y = qp + 12
    qp_u = qp_v = chroma_qp_dynamic(qp, 1) + 12
    a1 = analyze_frame_main(y, u, v, qp, qp_y, qp_u, qp_v, 10)
    a2 = analyze_frame_main_jax(y, u, v, qp, qp_y, qp_u, qp_v, 10)
    for lg in range(2, 7):
        if a1.mode[lg].size == 0:
            continue
        agree = (a1.mode[lg] == a2.mode[lg]).mean()
        assert agree > 0.97, (lg, agree)
        if lg in a1.split and a1.split[lg].size:
            assert (a1.split[lg] == a2.split[lg]).mean() > 0.97


def test_main_ai_multiframe_synthetic():
    """3-frame 128x96 synthetic AI clip round-trips through the decoder."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.gen_test_content import gen_frame
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    enc = Encoder(EncoderParams(w=128, h=96, qp=34, keyint=1, profile=1))
    stream = b""
    recs = []
    for t in range(3):
        yy, uu, vv = gen_frame(128, 96, t)
        bs, rec = enc.encode_frame(yy.astype(np.int32) << 2,
                                   uu.astype(np.int32) << 2,
                                   vv.astype(np.int32) << 2)
        stream += bs
        recs.append(rec)
    frames = BaselineIntraDecoder().decode(stream)
    assert len(frames) == 3
    for f, (ry, ru, rv) in zip(frames, recs):
        assert np.array_equal(f.y, ry)
        assert np.array_equal(f.u, ru)
        assert np.array_equal(f.v, rv)


def test_ats_encode_roundtrip_and_parity():
    """ATS-intra encode (DST7xDST7 candidate, xevem_tq.c:684 forward): the
    native and numpy passes make identical decisions, streams decode
    bit-exactly, and the ats_intra_cu flag is actually exercised."""
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    rng = np.random.RandomState(9)
    w, h = 96, 80
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 9) % 512 + rng.randint(0, 300, (h, w))).clip(0, 1023)
    u = rng.randint(300, 700, (h // 2, w // 2)).astype(np.int32)
    v = rng.randint(300, 700, (h // 2, w // 2)).astype(np.int32)
    e1 = Encoder(EncoderParams(w=w, h=h, qp=27, keyint=1, profile=1),
                 coder="numpy")
    e2 = Encoder(EncoderParams(w=w, h=h, qp=27, keyint=1, profile=1,
                               exact_rd=0), coder="native")
    b1, r1 = e1.encode_frame(y, u, v)
    b2, r2 = e2.encode_frame(y, u, v)
    assert b1 == b2
    f = BaselineIntraDecoder().decode(b2)[0]
    assert np.array_equal(f.y, r2[0])
    # ats off must differ (the flag bit alone changes the payload)
    e3 = Encoder(EncoderParams(w=w, h=h, qp=27, keyint=1, profile=1,
                               tool_ats=0, exact_rd=0), coder="native")
    b3, _ = e3.encode_frame(y, u, v)
    assert b3 != b2


def test_htdf_native_encode_roundtrip():
    """Native HTDF (xt_htdf_cu, ops/htdf_np.py port): byte-exact vs the
    numpy pass and bit-exact through the decoder."""
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    from tools.gen_test_content import gen_frame
    y, u, v = gen_frame(96, 80, 0)
    y, u, v = y.astype(np.int16) << 2, u.astype(np.int16) << 2, \
        v.astype(np.int16) << 2
    p = dict(w=96, h=80, qp=27, keyint=1, profile=1, tool_htdf=1,
             exact_rd=0)
    e1 = Encoder(EncoderParams(**p), coder="numpy")
    e2 = Encoder(EncoderParams(**p), coder="native")
    b1, r1 = e1.encode_frame(y, u, v)
    b2, r2 = e2.encode_frame(y, u, v)
    assert b1 == b2
    for a, b in zip(r1, r2):
        assert np.array_equal(a, b)
    f = BaselineIntraDecoder().decode(b2)[0]
    assert np.array_equal(f.y, r2[0])
