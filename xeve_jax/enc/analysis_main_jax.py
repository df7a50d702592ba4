"""Device analysis stage for the Main profile: batched 33-mode EIPD intra.

Same structure as analysis_jax.py (dense per-level evaluation, no
gathers) extended to the EIPD predictor set:
  - the 30 shift/filter modes (angular + V/H) become constant one-hot
    weight matrices (from ops/intra_main_batch.ang_tables) applied as a
    single (33, s^2, 2s+1) einsum per level
  - DC / plane / bi-linear are direct batched float formulas
  - IQT quantization scales, DM chroma (chroma follows the luma mode)

Decisions only (f32): the closed-loop native pass recomputes exact
integers; the numpy twin (analysis_main_np.py) is the golden reference.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..constants import (QUANT_SCALE, DQUANT_SCALE_MAIN,
                         MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT)
from ..ops.intra_main_batch import ang_tables
from ..ops.intra_main_np import (LUT_SIZE_PLUS1, _IB_MULT, _IB_SHIFT,
                                 IPD_CNT)
from .analysis_np import AnalysisResult
from .analysis_jax import (_blocks, _tq_cost, _partition_dp,
                           MATMUL_PRECISION)


@functools.lru_cache(maxsize=None)
def _ang_weights(s: int):
    """(30, s*s, 2s+1) up/left weight matrices covering modes
    3..11, 12(V), 13..23, 24(H), 25..32; weights are the 4-tap ADI filter
    values (sum 128), V/H rows are 128-one-hots."""
    n = 2 * s + 1
    modes = list(range(3, 33))
    Wu = np.zeros((len(modes), s * s, n), np.float32)
    Wl = np.zeros((len(modes), s * s, n), np.float32)
    for mi, m in enumerate(modes):
        if m == 12:        # VER: pred[j,i] = up[i]
            for j in range(s):
                for i in range(s):
                    Wu[mi, j * s + i, 1 + i] = 128.0
            continue
        if m == 24:        # HOR
            for j in range(s):
                for i in range(s):
                    Wl[mi, j * s + i, 1 + j] = 128.0
            continue
        src, idx, filt = ang_tables(m, s, s)
        for j in range(s):
            for i in range(s):
                p = j * s + i
                W = Wu if src[j, i] == 0 else Wl
                for k in range(4):
                    W[mi, p, idx[j, i, k]] += float(filt[j, i, k])
    return Wu, Wl


def _pred_all_modes_main(up, left, s, bd):
    """up/left: (nby, nbx, 2s+1) f32.  Returns (nby, nbx, 33, s, s)."""
    nby, nbx, _ = up.shape
    lg = s.bit_length() - 1
    maxv = float((1 << bd) - 1)
    # DC (reciprocal LUT; square -> asp 0)
    ssum = up[:, :, 1:1 + s].sum(-1) + left[:, :, 1:1 + s].sum(-1) + s
    dc = jnp.floor(ssum * LUT_SIZE_PLUS1[0] / float(1 << (lg + 12)))
    p_dc = jnp.broadcast_to(dc[:, :, None, None], (nby, nbx, s, s))
    # plane
    w2 = s >> 1
    idx = max(lg - 2, 0)
    im, ish = float(_IB_MULT[idx]), _IB_SHIFT[idx]
    ks = jnp.arange(1, w2 + 1, dtype=jnp.float32)
    coef_h = (ks * (up[:, :, 1 + w2 - 1 + 1:1 + w2 + w2] -
                    up[:, :, 1 + w2 - 2::-1][:, :, :w2])).sum(-1)
    coef_v = (ks * (left[:, :, 1 + w2 - 1 + 1:1 + w2 + w2] -
                    left[:, :, 1 + w2 - 2::-1][:, :, :w2])).sum(-1)
    a = (left[:, :, 1 + s - 1] + up[:, :, 1 + s - 1]) * 16.0
    b = jnp.floor((coef_h * 32.0 * im + (1 << (ish - 1))) / float(1 << ish))
    cc = jnp.floor((coef_v * 32.0 * im + (1 << (ish - 1))) / float(1 << ish))
    base = a - (w2 - 1) * cc - (w2 - 1) * b + 16.0
    ys = jnp.arange(s, dtype=jnp.float32)
    xs = jnp.arange(s, dtype=jnp.float32)
    p_pln = jnp.floor((base[:, :, None, None]
                       + ys[None, None, :, None] * cc[:, :, None, None]
                       + xs[None, None, None, :] * b[:, :, None, None])
                      / 32.0)
    p_pln = jnp.clip(p_pln, 0.0, maxv)
    # bi-linear (square)
    aa = up[:, :, 1 + s]
    bb = left[:, :, 1 + s]
    c0 = jnp.floor((aa + bb + 1) / 2.0)
    wt = 2.0 * c0 - aa - bb
    ref_up = up[:, :, 1:1 + s]
    ref_le = left[:, :, 1:1 + s]
    xs1 = jnp.arange(1, s + 1, dtype=jnp.float32)
    predx = (ref_le * (1 << lg))[:, :, :, None] + \
        (aa[:, :, None] - ref_le)[:, :, :, None] * xs1[None, None, None, :]
    refu = (ref_up * (1 << lg))[:, :, None, :] + \
        (bb[:, :, None] - ref_up)[:, :, None, :] * xs1[None, None, :, None]
    wxy = (jnp.arange(s, dtype=jnp.float32)[None, None, :, None] *
           wt[:, :, None, None]) * xs[None, None, None, :]
    p_bi = jnp.floor((predx * (1 << lg) + refu * (1 << lg) + wxy +
                      (1 << (2 * lg))) / float(1 << (2 * lg + 1)))
    p_bi = jnp.clip(p_bi, 0.0, maxv)
    # angular + V/H via one-hot matmuls
    Wu, Wl = _ang_weights(s)
    raw = (jnp.einsum('mpk,yxk->yxmp', jnp.asarray(Wu), up,
                      precision=MATMUL_PRECISION) +
           jnp.einsum('mpk,yxk->yxmp', jnp.asarray(Wl), left,
                      precision=MATMUL_PRECISION))
    p_ang = jnp.clip(jnp.floor((raw + 64.0) / 128.0),
                     0.0, maxv).reshape(nby, nbx, 30, s, s)
    return jnp.concatenate([p_dc[:, :, None], p_pln[:, :, None],
                            p_bi[:, :, None], p_ang], axis=2)


def _nbr_main_jax(plane, s, bd):
    """Open-loop neighbour arrays (nby, nbx, 2s+1) following
    ops/intra_main_batch.open_loop_neighbors (slices/concats only)."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    mid = jnp.float32(1 << (bd - 1))
    # right-extended rows above each block row (keep real pixels in
    # [wc, w) before edge-replicating, matching open_loop_neighbors)
    padr = jnp.concatenate([plane,
                            jnp.repeat(plane[:, w - 1:w], s, axis=1)],
                           axis=1)[:, :wc + s]           # (h, wc+s)
    rows = padr[s - 1:hc - 1:s, :]                       # (nby-1, wc+s)
    A = jnp.concatenate([jnp.full((1, wc + s), mid), rows], axis=0)
    Ab = A.reshape(nby, nbx + 1, s)
    upA, upB = Ab[:, :nbx], Ab[:, 1:nbx + 1]
    up_seg = jnp.concatenate([upA, upB], axis=2)         # (nby, nbx, 2s)
    # corner: A[j, i*s-1] for i>0, A[j, 0] for i==0
    corner = jnp.concatenate([A[:, 0:1], A[:, s - 1:nbx * s - 1:s]], axis=1)
    up = jnp.concatenate([corner[:, :, None], up_seg], axis=2)
    # left columns
    padb = jnp.concatenate([plane,
                            jnp.repeat(plane[h - 1:h, :], s, axis=0)],
                           axis=0)[:hc + s, :]           # (hc+s, w)
    if nbx > 1:
        Bc = padb[:, s - 1:nbx * s - 1:s]                # (hc+s, nbx-1)
        Br = Bc.reshape(nby + 1, s, nbx - 1)
        leA, leB = Br[:nby], Br[1:nby + 1]
        le_seg = jnp.concatenate([leA, leB], axis=1)     # (nby, 2s, nbx-1)
        le_seg = le_seg.transpose(0, 2, 1)               # (nby, nbx-1, 2s)
        le0 = jnp.broadcast_to(corner[:, 0:1, None], (nby, 1, 2 * s))
        le_seg = jnp.concatenate([le0, le_seg], axis=1)
    else:
        le_seg = jnp.broadcast_to(corner[:, 0:1, None], (nby, 1, 2 * s))
    left = jnp.concatenate([corner[:, :, None], le_seg], axis=2)
    return up, left


def main_quant_params(qp: int, bd: int, log2s: int):
    """IQT quantizer parameters (QUANT_SCALE[1] / DQUANT_SCALE_MAIN)."""
    scale = float(QUANT_SCALE[1][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = float(171 << (shift_q - 9))
    dq_scale = float(int(DQUANT_SCALE_MAIN[qp % 6]) << (qp // 6))
    return scale, offset, float(1 << shift_q), dq_scale


def level_params_main(qp, qp_y, qp_u, qp_v, bd, lg):
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    p = (list(main_quant_params(qp_y, bd, lg)) +
         list(main_quant_params(qp_u, bd, lg - 1)) +
         list(main_quant_params(qp_v, bd, lg - 1)) + [lam, w_u, w_v])
    return np.asarray(p, dtype=np.float32)


def _level_cost_main_impl(orig_y, orig_u, orig_v, prm, bd, lg):
    s = 1 << lg
    sc = s >> 1
    oy = _blocks(orig_y, s)
    upY, leY = _nbr_main_jax(orig_y, s, bd)
    pY = _pred_all_modes_main(upY, leY, s, bd)
    dY, bY = _tq_cost(oy, pY, prm[0:4], bd, s)
    ou = _blocks(orig_u, sc)
    ov = _blocks(orig_v, sc)
    upU, leU = _nbr_main_jax(orig_u, sc, bd)
    upV, leV = _nbr_main_jax(orig_v, sc, bd)
    pU = _pred_all_modes_main(upU, leU, sc, bd)
    pV = _pred_all_modes_main(upV, leV, sc, bd)
    dU, bU = _tq_cost(ou, pU, prm[4:8], bd, sc)
    dV, bV = _tq_cost(ov, pV, prm[8:12], bd, sc)
    lam, w_u, w_v = prm[12], prm[13], prm[14]
    nby, nbx = dY.shape[:2]
    cost = (dY + w_u * dU[:nby, :nbx] + w_v * dV[:nby, :nbx] +
            lam * (bY + bU[:nby, :nbx] + bV[:nby, :nbx] + 7.0))
    return jnp.argmin(cost, axis=2).astype(jnp.int32), jnp.min(cost, axis=2)


_level_cost_main = jax.jit(_level_cost_main_impl, static_argnames=("bd", "lg"))


@jax.jit
def _pack_main(parts):
    return jnp.concatenate([p.astype(jnp.float32).reshape(-1)
                            for p in parts])


def dispatch_main_jax(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                      max_log2=6, min_log2=2):
    """Async dispatch: all level executables queued, one packed device
    vector returned (device array, not fetched)."""
    h, w = orig_y.shape
    yj = jnp.asarray(np.asarray(orig_y), dtype=jnp.float32)
    uj = jnp.asarray(np.asarray(orig_u), dtype=jnp.float32)
    vj = jnp.asarray(np.asarray(orig_v), dtype=jnp.float32)
    parts = []
    levels = []
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        if h // s == 0 or w // s == 0:
            continue
        prm = jnp.asarray(level_params_main(qp, qp_y, qp_u, qp_v, bd, lg))
        m, c = _level_cost_main(yj, uj, vj, prm, bd=bd, lg=lg)
        parts.extend((m, c))
        levels.append(lg)
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    return (_pack_main(parts), levels, h, w, lam, min_log2, max_log2)


def collect_main_jax(handle) -> AnalysisResult:
    """Block on the single packed transfer and build the decision maps."""
    dev_vec, levels, h, w, lam, min_log2, max_log2 = handle
    vec = np.asarray(dev_vec)
    mode, leaf_cost = {}, {}
    for lg in range(min_log2, max_log2 + 1):
        if lg not in levels:
            s = 1 << lg
            mode[lg] = np.zeros((h // s, w // s), np.int32)
            leaf_cost[lg] = np.full(mode[lg].shape, np.inf)
    off = 0
    for lg in levels:
        s = 1 << lg
        nby, nbx = h // s, w // s
        n = nby * nbx
        mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
        off += n
        leaf_cost[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.float64)
        off += n
    res = _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2)
    res.eipd_modes = True      # mode maps hold EIPD directions (0..32)
    return res


def analyze_frame_main_jax(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                           max_log2=6, min_log2=2) -> AnalysisResult:
    return collect_main_jax(dispatch_main_jax(
        orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd, max_log2,
        min_log2))
