"""Frame-DAG parallel coding pass: the RA sub-GOP's closed-loop C passes
run concurrently (each task blocks only on the recon of its frozen ref
lists), a frame-level parallel axis the reference lacks (SURVEY.md §2.4).
The bitstream must be bit-identical to the serial path: ref lists are
frozen from the shadow DPB in coding order and emission stays serial.
"""
import os

import numpy as np
import pytest

from xeve_jax.api import GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder

W, H = 128, 64


def _frames(n, w=W, h=H):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _encode(frames, workers):
    os.environ["XEVE_FRAME_WORKERS"] = str(workers)
    try:
        enc = GopEncoder(EncoderParams(w=W, h=H, qp=30, keyint=0,
                                       bframes=15), analysis="device")
        chunks = {}
        for bs, _rec, poc in enc.encode_stream(iter(frames)):
            chunks[poc] = bs
        return b"".join(chunks[p] for p in sorted(chunks)), chunks
    finally:
        del os.environ["XEVE_FRAME_WORKERS"]


def test_parallel_equals_serial():
    frames = _frames(20)
    bs_par, chunks_par = _encode(frames, 3)
    bs_ser, chunks_ser = _encode(frames, 1)
    assert set(chunks_par) == set(chunks_ser)
    for poc in chunks_ser:
        assert chunks_par[poc] == chunks_ser[poc], f"poc {poc} differs"


def test_parallel_decodes():
    frames = _frames(18)
    os.environ["XEVE_FRAME_WORKERS"] = "3"
    try:
        enc = GopEncoder(EncoderParams(w=W, h=H, qp=30, keyint=0,
                                       bframes=15), analysis="device")
        bs = b""
        recs = {}
        for out, rec, poc in enc.encode_stream(iter(frames)):
            bs += out
            recs[poc] = rec
    finally:
        del os.environ["XEVE_FRAME_WORKERS"]
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == 18
    for f in dec:
        assert np.array_equal(f.y, recs[f.poc][0])


def test_parallel_ai_equals_serial():
    """All-intra frame-parallel C passes must be bit-identical to serial."""
    frames = _frames(6)

    def run(workers):
        os.environ["XEVE_FRAME_WORKERS"] = str(workers)
        try:
            from xeve_jax.api import Encoder
            enc = Encoder(EncoderParams(w=W, h=H, qp=30, keyint=1),
                          analysis="device")
            out = []
            for bs, rec, poc in enc.encode_stream(iter(frames)):
                out.append((poc, bs, rec[0].tobytes()))
            return out
        finally:
            del os.environ["XEVE_FRAME_WORKERS"]

    a = run(3)
    b = run(1)
    assert len(a) == len(b) == 6
    for (pa, ba, ra), (pb, bb, rb) in zip(a, b):
        assert pa == pb and ba == bb and ra == rb
