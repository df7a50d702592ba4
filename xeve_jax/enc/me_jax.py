"""Dense full-search motion estimation on the device (JAX).

The search is a regular reduction: for every displacement in the window,
the absolute-difference plane is box-summed per 16x16 block; a lax.scan
over window rows keeps the live memory at one row strip of candidates.
This replaces the reference's sequential EPZS diamond search
(xeve_pinter.c:699) with a superset exhaustive search whose regular
reductions XLA fuses (SURVEY.md §7.1).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

BLK = 16


@functools.partial(jax.jit, static_argnames=("R", "pad"))
def _me_int_jit(cur, ref_pad, R: int, pad: int):
    """cur: (H, W) f32 (H,W multiples of 16); ref_pad: padded ref.
    Returns best integer mv (nby, nbx, 2) and SAD."""
    H, W = cur.shape
    nby, nbx = H // BLK, W // BLK

    dxs = jnp.arange(-R, R + 1)

    def row(carry, dy):
        best_sad, best_dx, best_dy = carry
        # one row strip of candidates; dx candidates are STATIC slices of it
        strip = jax.lax.dynamic_slice(ref_pad, (pad + dy, 0),
                                      (H, W + 2 * pad))
        cands = jnp.stack([strip[:, pad - R + i:pad - R + i + W]
                           for i in range(2 * R + 1)])         # (2R+1, H, W)
        d = jnp.abs(cur[None] - cands)
        sads = d.reshape(2 * R + 1, nby, BLK, nbx, BLK).sum(axis=(2, 4))
        reg = (jnp.abs(dxs)[:, None, None] + jnp.abs(dy)).astype(cur.dtype)
        sads = sads + reg
        am = jnp.argmin(sads, axis=0)
        mn = jnp.min(sads, axis=0)
        upd = mn < best_sad
        best_sad = jnp.where(upd, mn, best_sad)
        best_dx = jnp.where(upd, dxs[am], best_dx)
        best_dy = jnp.where(upd, dy, best_dy)
        return (best_sad, best_dx, best_dy), None

    init = (jnp.full((nby, nbx), jnp.inf, cur.dtype),
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32))
    (best_sad, best_dx, best_dy), _ = jax.lax.scan(row, init,
                                                   jnp.arange(-R, R + 1))
    return jnp.stack([best_dx, best_dy], axis=-1), best_sad


def integer_me_jax(cur_y: np.ndarray, ref_y_pad: np.ndarray, pad: int,
                   search_range: int = 16):
    """numpy-facing wrapper; crops to the 16-aligned region like the numpy
    twin (analysis_inter_np.integer_me)."""
    h, w = cur_y.shape
    nby, nbx = h // BLK, w // BLK
    hc, wc = nby * BLK, nbx * BLK
    cur = jnp.asarray(cur_y[:hc, :wc], dtype=jnp.float32)
    # crop the padded ref so the padded origin aligns with the cropped frame
    refp = jnp.asarray(ref_y_pad[:pad * 2 + hc, :pad * 2 + wc],
                       dtype=jnp.float32)
    mv, sad = _me_int_jit(cur, refp, int(search_range), int(pad))
    return np.asarray(mv, dtype=np.int32), np.asarray(sad, dtype=np.int64)
