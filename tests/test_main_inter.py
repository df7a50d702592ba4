"""Main-profile P/B slices (EIPD + CM_INIT + ADCC + IQT in the native
inter coding pass): encode -> own conformance decoder bit-exact."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _frames(w, h, n):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int32) << 2, u.astype(np.int32) << 2,
                    v.astype(np.int32) << 2))
    return out


def test_main_ldp_roundtrip():
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    W, H = 128, 96
    enc = Encoder(EncoderParams(w=W, h=H, qp=32, keyint=0, profile=1),
                  coder="native")
    stream = b""
    recs = []
    for (y, u, v) in _frames(W, H, 5):
        bs, rec = enc.encode_frame(y, u, v)
        stream += bs
        recs.append(rec)
    dec = BaselineIntraDecoder()
    out = dec.decode(stream)
    assert dec.sps.tool_eipd and dec.sps.tool_adcc and dec.sps.tool_iqt
    assert len(out) == 5
    for f, r in zip(out, recs):
        assert np.array_equal(f.y, r[0])
        assert np.array_equal(f.u, r[1])
        assert np.array_equal(f.v, r[2])


def test_main_ra_gop16_roundtrip():
    from xeve_jax.api import GopEncoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    W, H = 128, 96
    enc = GopEncoder(EncoderParams(w=W, h=H, qp=32, keyint=0, bframes=15,
                                   profile=1), coder="native")
    stream = b""
    recs = {}
    for (y, u, v) in _frames(W, H, 18):
        for bs, rec, poc in enc.push_frame(y, u, v):
            stream += bs
            recs[poc] = rec
    for bs, rec, poc in enc.flush():
        stream += bs
        recs[poc] = rec
    out = BaselineIntraDecoder().decode(stream)
    assert len(out) == len(recs) == 18
    for f in out:
        r = recs[f.poc]
        assert np.array_equal(f.y, r[0]), f.poc
        assert np.array_equal(f.u, r[1]), f.poc
        assert np.array_equal(f.v, r[2]), f.poc
