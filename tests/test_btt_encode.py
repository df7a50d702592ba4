"""BTT split-tree ENCODING, stage 1 (opt-in `btt=1`): the device's quad
partitions are emitted as binary-tree syntax (square node -> BI_VER ->
two tall rects -> BI_HOR), so every leaf CU stays square and the
existing CU coders apply while the full btt_split_flag/dir/type syntax
(neighbour-size contexts, implied bins, forced boundary splits) goes on
the wire.  The own conformance decoder — reference-validated against
xeve btt streams (tests/test_conformance.py BTT cases) — is the oracle.
"""
import numpy as np

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder


def _frames(n, w=96, h=80):
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def test_btt_ai_roundtrip():
    frames = _frames(3)
    enc = Encoder(EncoderParams(w=96, h=80, qp=30, keyint=1, profile=1,
                                btt=1), analysis="numpy", coder="native")
    bs = b""
    recs = []
    for (y, u, v) in frames:
        b, rec = enc.encode_frame(y, u, v)
        bs += b
        recs.append(rec)
    dec = BaselineIntraDecoder().decode(bs)
    assert dec[0].sps.sps_btt_flag if hasattr(dec[0], "sps") else True
    assert len(dec) == 3
    for i, f in enumerate(dec):
        assert np.array_equal(f.y, recs[i][0])
        assert np.array_equal(f.u, recs[i][1])
        assert np.array_equal(f.v, recs[i][2])


def test_btt_ra_roundtrip():
    """RA GOP16 with btt: P/B leaves under binary-split syntax, forced
    boundary splits on the 96x80 (non-64-multiple) frame."""
    frames = _frames(18)
    enc = GopEncoder(EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=15,
                                   profile=1, btt=1), analysis="device")
    bs = b""
    recs = {}
    for out, rec, poc in enc.encode_stream(iter(frames)):
        bs += out
        recs[poc] = rec
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == 18
    for f in dec:
        assert np.array_equal(f.y, recs[f.poc][0])
        assert np.array_equal(f.u, recs[f.poc][1])
        assert np.array_equal(f.v, recs[f.poc][2])
