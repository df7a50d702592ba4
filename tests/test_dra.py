"""DRA — dynamic range adjustment (APS-signalled, Main profile).

Golden conformance: reference-encoder streams with tool_dra=1 decode
bit-exactly INCLUDING the backward map on outputs (the reference's -r
recon dump goes through CFG_GET_RECON which backward-maps,
xevem.c:1036).  Two different scale maps (8 uneven ranges AI, 4 ranges
LD) exercise the LUT construction, the chroma QP-model correction and
the fixed-point forward/inverse builders (ops/dra_np.py ports of
xevem_dra.c).  Encode: own streams with DRA round-trip through the own
decoder in AI/LD/RA."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.dec.decoder import BaselineIntraDecoder

DATA = os.path.join(os.path.dirname(__file__), "data")
W, H = 96, 80
FSZ = W * H + 2 * (W // 2) * (H // 2)


@pytest.mark.parametrize("name", ["s96_dra_ai", "s96_dra_ld"])
def test_golden_dra_decode(name):
    bs = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    dec = BaselineIntraDecoder()
    frames = dec.decode(bs)
    assert dec.sps.tool_dra == 1
    assert dec.pps.pic_dra_enabled_flag == 1
    assert 0 in dec.dra_aps
    rec = np.fromfile(os.path.join(DATA, f"{name}_rec.yuv"), dtype="<u2")
    n = len(rec) // FSZ
    assert len(frames) == n
    for i, f in enumerate(frames):
        r = rec[i * FSZ:(i + 1) * FSZ]
        assert np.array_equal(f.y, r[:W * H].reshape(H, W)), f"{name} {i}"
        assert np.array_equal(
            f.u, r[W * H:W * H + (W // 2) * (H // 2)].reshape(H // 2, W // 2))
        assert np.array_equal(
            f.v, r[W * H + (W // 2) * (H // 2):].reshape(H // 2, W // 2))


def test_dra_lut_roundtrip():
    """Forward->inverse luma LUT composition is near-identity inside the
    mapped range (fixed-point quantization allows +-1)."""
    from xeve_jax.ops.dra_np import derive_sig_params, build_dra_maps
    sig = derive_sig_params(32, num_ranges=8,
                            in_points=[64, 128, 192, 256, 384, 512, 640,
                                       768],
                            scales=[1.0, 1.2, 1.4, 1.3, 1.2, 1.1, 1.0, 0.9])
    maps = build_dra_maps(sig, 10)
    x = np.arange(1024)
    rt = maps.luma_inv_lut[maps.luma_fwd_lut[x]]
    assert np.abs(rt - x)[64:940].max() <= 1


@pytest.mark.parametrize("ki,bf", [(1, 0), (0, 0), (0, 15)])
def test_dra_own_roundtrip(ki, bf):
    from tools.gen_test_content import gen_frame
    from xeve_jax.api import Encoder, GopEncoder
    from xeve_jax.params import EncoderParams
    n = 20 if bf else 4
    frames = []
    for t in range(n):
        y, u, v = gen_frame(W, H, t)
        frames.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                       v.astype(np.int16) << 2))
    cls = GopEncoder if bf else Encoder
    enc = cls(EncoderParams(w=W, h=H, qp=32, keyint=ki, bframes=bf,
                            profile=1, tool_dra=1),
              analysis="numpy", coder="native")
    bs = b""
    recs = {}
    for out, rec, poc in enc.encode_stream(iter(frames)):
        bs += out
        recs[poc] = rec
    dec = BaselineIntraDecoder()
    for f in dec.decode(bs):
        # encoder returns display-domain recon; decoder output likewise
        assert np.array_equal(f.y, recs[f.poc][0][:H, :W])
        assert np.array_equal(f.u, recs[f.poc][1][:H // 2, :W // 2])
        assert np.array_equal(f.v, recs[f.poc][2][:H // 2, :W // 2])
    assert dec.pps.pic_dra_enabled_flag == 1
