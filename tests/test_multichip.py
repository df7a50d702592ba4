"""Multi-chip: the RA sub-GOP analysis sharded over an 8-device mesh must
produce the SAME bitstream as the single-chip device path (SURVEY.md §4d:
N-chip output == 1-chip output)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _frames(w, h, n):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def test_meshed_subgop_bitstream_determinism():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    from xeve_jax.api import GopEncoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.parallel.mesh import make_mesh

    W, H = 128, 64
    frames = _frames(W, H, 18)

    def run(meshed):
        enc = GopEncoder(EncoderParams(w=W, h=H, qp=33, keyint=0,
                                       bframes=15), analysis="device",
                         coder="native")
        out = b""
        if meshed:
            mesh = make_mesh(len(jax.devices()))
            for bs, rec, poc in enc.encode_stream_meshed(iter(frames), mesh):
                out += bs
        else:
            for bs, rec, poc in enc.encode_stream(iter(frames)):
                out += bs
        return out

    one = run(False)
    n = run(True)
    assert one == n, (len(one), len(n))

    # and the stream is valid
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    fr = BaselineIntraDecoder().decode(n)
    assert len(fr) == 18
