"""Device-analyzer (fused single-dispatch) path: stream encode round-trips
bit-exactly through the own conformance decoder for LD-P and RA GOP16.

The device analyzer runs ME against device-resident *originals* (open
loop); conformance is guaranteed by the closed-loop native coding pass, so
these tests assert decode bit-exactness + sane quality, not decision
agreement with the numpy oracle.
"""
import numpy as np
import pytest

from xeve_jax.api import Encoder, GopEncoder, psnr
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder

W, H = 128, 64


def _frames(n, w=W, h=H):
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def test_device_ld_stream_roundtrip():
    frames = _frames(5)
    enc = Encoder(EncoderParams(w=W, h=H, qp=30, keyint=0),
                  analysis="device")
    bs = b""
    recs = []
    for out, rec, poc in enc.encode_stream(frames, ahead=2):
        bs += out
        recs.append((poc, rec))
    assert [p for p, _ in recs] == list(range(5))
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == 5
    for i, (poc, rec) in enumerate(recs):
        assert dec[i].poc == poc
        assert np.array_equal(dec[i].y, rec[0])
        assert np.array_equal(dec[i].u, rec[1])
        assert np.array_equal(dec[i].v, rec[2])
    p = np.mean([psnr(rec[0], frames[poc][0]) for poc, rec in recs])
    assert p > 30.0, p


def test_device_ra_stream_roundtrip():
    frames = _frames(18)
    enc = GopEncoder(EncoderParams(w=W, h=H, qp=30, keyint=0, bframes=15),
                     analysis="device")
    bs = b""
    n = 0
    pocs = set()
    for out, rec, poc in enc.encode_stream(frames):
        bs += out
        pocs.add(poc)
        n += 1
    assert n == 18 and pocs == set(range(18))
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == 18
    ps = [psnr(f.y, frames[f.poc][0]) for f in dec]
    assert np.mean(ps) > 30.0, np.mean(ps)
