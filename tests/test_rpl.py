"""RPL — explicit reference picture list signalling + >2 active refs.

Golden conformance: reference-encoder Main streams with tool_rpl=1 +
tool_pocs=1 (explicit POC lsb in the slice header, SPS rpl structs, SH
rpl override/inference per xevem_eco.c:595-617, RPL-based list
construction xevem_picman.c:578 and marking :632) decode bit-exactly.
Encode: up to 4 active refs per list round-trip through the own decoder
(refi >= 2 candidates seed from POC-scaled refi-0 MVs and are refined
closed-loop in the native pass)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.dec.decoder import BaselineIntraDecoder

DATA = os.path.join(os.path.dirname(__file__), "data")
W, H = 96, 80
FSZ = W * H + 2 * (W // 2) * (H // 2)


@pytest.mark.parametrize("name,reorder", [
    ("s96_rpl_ld", False), ("s96_rpl_ra", True)])
def test_golden_rpl_decode(name, reorder):
    bs = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    dec = BaselineIntraDecoder()
    frames = dec.decode(bs)
    assert dec.sps.tool_rpl == 1 and dec.sps.tool_pocs == 1
    assert len(dec.sps.rpls_l0) > 0
    if reorder:
        frames = sorted(frames, key=lambda f: f.poc)
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


@pytest.mark.parametrize("nref", [3, 4])
def test_multiref4_roundtrip(nref):
    """LD with up to 4 active refs: lists reach the native pass and the
    stream stays decodable with matching recon."""
    from tools.gen_test_content import gen_frame
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    frames = []
    for t in range(8):
        y, u, v = gen_frame(W, H, t)
        frames.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                       v.astype(np.int16) << 2))
    enc = Encoder(EncoderParams(w=W, h=H, qp=30, keyint=0, ref_pics=nref),
                  analysis="numpy", coder="native")
    bs = b""
    recs = {}
    for out, rec, poc in enc.encode_stream(iter(frames)):
        bs += out
        recs[poc] = rec
    assert enc.sps.max_num_ref_pics == nref
    for f in BaselineIntraDecoder().decode(bs):
        assert np.array_equal(f.y, recs[f.poc][0][:H, :W])
        assert np.array_equal(f.u, recs[f.poc][1][:H // 2, :W // 2])
        assert np.array_equal(f.v, recs[f.poc][2][:H // 2, :W // 2])
