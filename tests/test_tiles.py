"""Tiles: conformance (reference multi-tile streams decode bit-exactly),
own multi-tile round-trip, entry points, thread-count invariance."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.conftest import DATA, load_rec10


TILE_CASES = [
    # (name, w, h, frames) — generated via tools/ref_driver (Main profile,
    # tools-off / stage-1 subsets, uniform tiles, lf-across-tiles off)
    ("t176_2t_ai", 176, 144, 2),   # 2x1 tiles, tools off
    ("t176_4t_ai", 176, 144, 2),   # 2x2 tiles, eipd+cm_init+adcc+iqt
    ("t176_2t_zl", 176, 144, 4),   # 2x1 tiles, low-delay
]


@pytest.mark.parametrize("name,w,h,n", TILE_CASES)
def test_decode_reference_tile_stream(name, w, h, n):
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    stream = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    dec = BaselineIntraDecoder()
    frames = dec.decode(stream)
    assert dec.pps.single_tile_in_pic_flag == 0
    assert dec.signatures_checked == n
    assert len(frames) == n
    for i, f in enumerate(frames):
        gy, gu, gv = load_rec10(os.path.join(DATA, f"{name}_rec.yuv"), w, h, i)
        assert np.array_equal(f.y, gy), f"{name} frame {i} luma"
        assert np.array_equal(f.u, gu)
        assert np.array_equal(f.v, gv)


def _frames(w, h, n):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int32) << 2, u.astype(np.int32) << 2,
                    v.astype(np.int32) << 2))
    return out


def test_own_multitile_roundtrip_and_thread_invariance():
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    W, H = 176, 144
    (y, u, v), = _frames(W, H, 1)
    outs = []
    for th in (1, 2):
        enc = Encoder(EncoderParams(w=W, h=H, qp=32, keyint=1, profile=1,
                                    tile_columns=2, tile_rows=2, threads=th,
                                    use_pic_sign=True))
        bs, rec = enc.encode_frame(y, u, v)
        outs.append((bs, rec))
    # bitstream must be invariant to the worker count (per-tile substreams)
    assert outs[0][0] == outs[1][0]
    dec = BaselineIntraDecoder()
    f = dec.decode(outs[1][0])[0]
    assert dec.sps.profile_idc == 1
    assert dec.pps.num_tile_columns_minus1 == 1
    assert len(dec.sh.entry_point_offsets) == 3
    assert np.array_equal(f.y, outs[1][1][0])
    assert np.array_equal(f.u, outs[1][1][1])
    assert np.array_equal(f.v, outs[1][1][2])


def test_own_multitile_inter_roundtrip():
    from xeve_jax.api import GopEncoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    W, H = 176, 144
    enc = GopEncoder(EncoderParams(w=W, h=H, qp=32, keyint=0, bframes=15,
                                   profile=1, tile_columns=2, threads=2))
    stream = b""
    recs = {}
    for fr in _frames(W, H, 18):
        for bs, rec, poc in enc.push_frame(*fr):
            stream += bs
            recs[poc] = rec
    for bs, rec, poc in enc.flush():
        stream += bs
        recs[poc] = rec
    out = BaselineIntraDecoder().decode(stream)
    assert len(out) == 18
    for f in out:
        assert np.array_equal(f.y, recs[f.poc][0]), f.poc
        assert np.array_equal(f.u, recs[f.poc][1]), f.poc
        assert np.array_equal(f.v, recs[f.poc][2]), f.poc
