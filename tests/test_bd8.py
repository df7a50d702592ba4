"""8-bit internal coding (inc/xeve.h:345 codec_bit_depth): full encode/
decode round-trips at codec_bit_depth=8 across AI/LD/RA and Main AI."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder


def _frames(n, w=96, h=80):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16), u.astype(np.int16),
                    v.astype(np.int16)))       # 8-bit sample values
    return out


@pytest.mark.parametrize("prof,bf,ki", [(0, 0, 1), (0, 0, 0), (0, 15, 0),
                                        (1, 0, 1)])
def test_bd8_roundtrip(prof, bf, ki):
    frames = _frames(8)
    p = EncoderParams(w=96, h=80, qp=30, keyint=ki, bframes=bf,
                      profile=prof, codec_bit_depth=8)
    cls = GopEncoder if bf else Encoder
    enc = cls(p, analysis="numpy", coder="native")
    outs = list(enc.encode_stream(iter(frames)))
    bs = b"".join(o[0] for o in outs)
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == len(outs)
    assert dec[0].y.max() <= 255          # truly 8-bit internal
    for d, (_, rec, _) in zip(dec, outs):
        assert np.array_equal(d.y, rec[0])
        assert np.array_equal(d.u, rec[1])
        assert np.array_equal(d.v, rec[2])


def test_bd8_sps_signals_depth():
    from xeve_jax.hls import SPS, split_nals
    from xeve_jax.io.bits import BitReader
    frames = _frames(1)
    p = EncoderParams(w=96, h=80, qp=30, keyint=1, codec_bit_depth=8)
    enc = Encoder(p, analysis="numpy", coder="native")
    bs, _ = enc.encode_frame(*frames[0])
    for hdr, payload, _f in split_nals(bs):
        if hdr.nal_unit_type == 24:
            s = SPS.parse(BitReader(payload))
            assert s.bit_depth_luma_minus8 == 0
            return
    raise AssertionError("no SPS found")
