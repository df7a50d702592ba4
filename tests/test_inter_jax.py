"""JAX inter analysis (ME + subpel + level costs on device) end-to-end:
streams must decode bit-exactly and land at the numpy analysis RD point."""
import numpy as np
import pytest

from xeve_jax.params import EncoderParams
from xeve_jax.api import Encoder, psnr
from xeve_jax.dec.decoder import BaselineIntraDecoder


def synth(n, w, h, seed=3):
    rng = np.random.default_rng(seed)
    base_y = rng.integers(64, 900, (h, w)).astype(np.int32)
    frames = []
    for t in range(n):
        y = np.roll(base_y, (t * 2, t * 3), axis=(0, 1)) \
            + rng.integers(-8, 8, (h, w))
        u = rng.integers(400, 600, (h // 2, w // 2)).astype(np.int32)
        v = np.roll(u, t, axis=1)
        frames.append((np.clip(y, 0, 1023), np.clip(u, 0, 1023), v))
    return frames


def test_jax_inter_analysis_roundtrip_and_rd():
    frames = synth(4, 128, 64)
    res = {}
    for eng in ("numpy", "jax"):
        enc = Encoder(EncoderParams(w=128, h=64, qp=30, keyint=0),
                      analysis=eng, coder="native")
        bs_all = b""
        recs = []
        for f in frames:
            bs, rec = enc.encode_frame(*f)
            bs_all += bs
            recs.append(rec)
        dec = BaselineIntraDecoder().decode(bs_all)
        assert len(dec) == len(frames)
        for i, df in enumerate(dec):
            assert np.array_equal(df.y, recs[i][0]), \
                f"{eng} frame {i}: decode != encoder recon"
        ps = float(np.mean([psnr(r[0], f[0]) for r, f in zip(recs, frames)]))
        res[eng] = (len(bs_all), ps)
    # same quality ballpark as the exact-integer numpy analysis
    assert abs(res["jax"][1] - res["numpy"][1]) < 1.0
    assert res["jax"][0] < res["numpy"][0] * 1.3


def test_jax_subpel_matches_oracle_selection():
    """Phase-plane MC inside the JAX analysis is integer-exact: the subpel
    SAD surface must match the numpy oracle's MC-based SAD for any MV."""
    import jax.numpy as jnp
    from xeve_jax.ops import mc_np
    from xeve_jax.enc.analysis_inter_jax import (_phase_planes,
                                                 _gather_blocks, PAD)
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 1024, (64, 64)).astype(np.int32)
    ref_pad = mc_np.pad_picture(ref, PAD)
    planes = np.asarray(_phase_planes(jnp.asarray(ref_pad, jnp.int32), 10))
    for mv in ((0, 0), (5, -3), (-2, 7), (1, 1), (-9, -6), (3, 2)):
        mv_q = np.tile(np.asarray(mv, np.int32), (2, 2, 1))
        g = np.asarray(_gather_blocks(jnp.asarray(planes), jnp.asarray(mv_q),
                                      16, PAD, 2, 2))
        for by in range(2):
            for bx in range(2):
                x, y = bx * 16, by * 16
                gx = ((x << 2) + mv[0]) << 2
                gy = ((y << 2) + mv[1]) << 2
                exact = mc_np.mc_luma(ref_pad, PAD, gx, gy, 16, 16, 10)
                assert np.array_equal(g[by, bx], exact), f"mv {mv} b({by},{bx})"
