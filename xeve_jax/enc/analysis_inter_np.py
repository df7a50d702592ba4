"""Inter (low-delay P) analysis: motion estimation + per-level mode costing
+ partition DP (numpy prototype of the device stage).

Batched design: full-search integer ME as dense SAD tensors over the
search window (regular computation, maps to dense device reductions —
SURVEY.md §7.1 'replace EPZS with hierarchical exhaustive search'), then
subpel refinement with the exact MC filters, then per-quadtree-level
inter/intra cost comparison and the same bottom-up DP as the intra path.

Because MC depends only on the (already reconstructed) reference picture,
inter analysis costs here are exact up to rate estimation; only intra
neighbours are open-loop.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import SLICE_P
from . import analysis_np
from .analysis_np import AnalysisResult, corrected_leaf
from ..ops import mc_np
from . import syntax

ME_BLK_LOG2 = 4  # 16x16 ME grid

@dataclass
class InterAnalysisResult(AnalysisResult):
    mv: dict = None          # per level: (nby, nbx, 2) quarter-pel (L0 refi 0)
    mv1: dict = None         # per level L1 MVs (B slices), else None
    mv0b: dict = None        # per level L0 refi=1 MVs (multi-ref), else None
    mv1b: dict = None        # per level L1 refi=1 MVs, else None
    mvbi: dict = None        # per level bi-refined L1 MVs (analyze_bi analog)
    mode_bias: dict = None


def integer_me(cur_y: np.ndarray, ref_y_pad: np.ndarray, pad: int,
               search_range: int = 16) -> np.ndarray:
    """Full-search integer ME on the 16x16 grid.  Returns (nby, nbx, 2)
    integer-pel MVs.  Dense SAD tensor over the whole window."""
    h, w = cur_y.shape
    s = 1 << ME_BLK_LOG2
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    cur = cur_y[:hc, :wc].astype(np.int32)
    R = search_range
    best_sad = np.full((nby, nbx), 1 << 60, dtype=np.int64)
    best_mv = np.zeros((nby, nbx, 2), dtype=np.int32)
    # cost bias toward small MVs (regularizer ~ mvd bins)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            ref = ref_y_pad[pad + dy:pad + dy + hc, pad + dx:pad + dx + wc]
            diff = np.abs(cur - ref.astype(np.int32))
            sad = diff.reshape(nby, s, nbx, s).sum(axis=(1, 3)).astype(np.int64)
            sad += (abs(dx) + abs(dy))  # tiny tie-break toward short MVs
            upd = sad < best_sad
            best_sad = np.where(upd, sad, best_sad)
            best_mv[upd] = (dx, dy)
    return best_mv, best_sad


def subpel_refine(cur_y, ref_y_pad, pad, int_mv, bd):
    """Quarter-pel refinement per 16x16 block around the integer MV
    (half-pel 3x3 then quarter-pel 3x3), using the exact MC filters."""
    h, w = cur_y.shape
    s = 1 << ME_BLK_LOG2
    nby, nbx = int_mv.shape[:2]
    out = np.zeros_like(int_mv)
    for by in range(nby):
        for bx in range(nbx):
            x, y = bx * s, by * s
            cur = cur_y[y:y + s, x:x + s].astype(np.int64)
            base = (int(int_mv[by, bx, 0]) << 2, int(int_mv[by, bx, 1]) << 2)
            best = base
            best_sad = None
            for step in (2, 1):
                center = best
                for dy in (-step, 0, step):
                    for dx in (-step, 0, step):
                        mv = (center[0] + dx, center[1] + dy)
                        gx = ((x << 2) + mv[0]) << 2
                        gy = ((y << 2) + mv[1]) << 2
                        pred = mc_np.mc_luma(ref_y_pad, pad, gx, gy, s, s, bd)
                        sad = int(np.abs(cur - pred).sum())
                        if best_sad is None or sad < best_sad:
                            best_sad, best = sad, mv
            out[by, bx] = best
    return out


def _mv_for_level(mv16: np.ndarray, lg: int, nby: int, nbx: int):
    """Per-level MV map from the 16x16 grid: containing block for small
    CUs, component-wise median of covered blocks for large CUs."""
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return np.repeat(np.repeat(mv16, f, axis=0), f, axis=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m_h, m_w = mv16.shape[:2]
    out = np.zeros((nby, nbx, 2), dtype=np.int32)
    for by in range(nby):
        for bx in range(nbx):
            blk = mv16[by * f:(by + 1) * f, bx * f:(bx + 1) * f].reshape(-1, 2)
            out[by, bx] = np.median(blk, axis=0).astype(np.int32)
    return out


def analyze_frame_inter(orig_y, orig_u, orig_v, refp, qp, qp_y, qp_u, qp_v,
                        bd, search_range=16, do_subpel=True, refp1=None,
                        max_log2=6, min_log2=2) -> InterAnalysisResult:
    """P/B-frame analysis: intra costs (open loop) + inter costs (exact MC
    on the real reference(s)) -> combined partition DP."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    h, w = orig_y.shape
    intra = analysis_np.analyze_frame(orig_y, orig_u, orig_v, qp, qp_y, qp_u,
                                      qp_v, bd, max_log2=max_log2,
                                      min_log2=min_log2)
    ref = refp[0]
    pad = 64 + 16
    mv16_i, _ = integer_me(orig_y, ref["y_pad"], pad, search_range)
    if do_subpel:
        mv16 = subpel_refine(orig_y, ref["y_pad"], pad, mv16_i, bd)
    else:
        mv16 = (mv16_i << 2)
    mv16_b = None
    if refp1 and refp1[0]["poc"] != ref["poc"]:
        mv16_i1, _ = integer_me(orig_y, refp1[0]["y_pad"], pad,
                                search_range)
        mv16_b = subpel_refine(orig_y, refp1[0]["y_pad"], pad, mv16_i1, bd) \
            if do_subpel else (mv16_i1 << 2)
    elif refp1:
        mv16_b = mv16

    def _extra_ref_me(r):
        mvi, _ = integer_me(orig_y, r["y_pad"], pad, search_range)
        return subpel_refine(orig_y, r["y_pad"], pad, mvi, bd) \
            if do_subpel else (mvi << 2)

    # multi-ref: per-ref ME planes for refi=1 of each list
    # (xeve_pinter.c:1839 per-ref ME loop)
    mv16_0b = _extra_ref_me(refp[1]) if len(refp) > 1 else None
    mv16_1b = _extra_ref_me(refp1[1]) if (refp1 and len(refp1) > 1) else None

    mode = {}
    mv = {}
    mv1 = {} if mv16_b is not None else None
    mv0b = {} if mv16_0b is not None else None
    mv1b = {} if mv16_1b is not None else None
    leaf_cost = {}
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        mv_l = _mv_for_level(mv16, lg, nby, nbx)
        cost_i = np.empty((nby, nbx))
        for by in range(nby):
            for bx in range(nbx):
                x, y = bx * s, by * s
                key = (int(mv_l[by, bx, 0]), int(mv_l[by, bx, 1]))
                py, pu, pv = mc_np.mc_cu(x, y, s, s, key, ref["y_pad"],
                                         ref["u_pad"], ref["v_pad"], pad,
                                         pad // 2, w, h, bd)
                sc = s >> 1
                xc, yc = x >> 1, y >> 1
                d = float(((orig_y[y:y + s, x:x + s] - py) ** 2).sum())
                d += w_u * float(((orig_u[yc:yc + sc, xc:xc + sc] - pu) ** 2).sum())
                d += w_v * float(((orig_v[yc:yc + sc, xc:xc + sc] - pv) ** 2).sum())
                bits = 8 + syntax.mvd_bits_est(key[0], key[1])
                # residual-coding proxy: assume T/Q removes ~60% of the
                # distortion at the cost of bits ~ d/qstep; keep it simple
                cost_i[by, bx] = min(d + lam * 4.0,        # skip-like
                                     0.35 * d + lam * (bits + 0.02 * d ** 0.5 * s))
        mode[lg] = intra.mode[lg]
        mv[lg] = mv_l
        if mv1 is not None:
            mv1[lg] = _mv_for_level(mv16_b, lg, nby, nbx)
        if mv0b is not None:
            mv0b[lg] = _mv_for_level(mv16_0b, lg, nby, nbx)
        if mv1b is not None:
            mv1b[lg] = _mv_for_level(mv16_1b, lg, nby, nbx)
        leaf_cost[lg] = np.minimum(intra.leaf_cost[lg], cost_i)

    tree_cost = {min_log2: corrected_leaf(min_log2, leaf_cost[min_log2])}
    split = {min_log2: np.zeros_like(leaf_cost[min_log2], dtype=bool)}
    for lg in range(min_log2 + 1, max_log2 + 1):
        s = 1 << lg
        nby, nbx = leaf_cost[lg].shape
        ch = tree_cost[lg - 1][:nby * 2, :nbx * 2]
        sum4 = ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] + ch[1::2, 1::2]
        ys = (np.arange(nby) + 1) * s
        xs = (np.arange(nbx) + 1) * s
        valid = (ys[:, None] <= h) & (xs[None, :] <= w)
        leafc = np.where(valid, corrected_leaf(lg, leaf_cost[lg]), np.inf)
        split[lg] = sum4 + lam < leafc
        tree_cost[lg] = np.where(split[lg], sum4 + lam, leafc)

    return InterAnalysisResult(mode=mode, split=split, leaf_cost=leaf_cost,
                               tree_cost=tree_cost, mv=mv, mv1=mv1,
                               mv0b=mv0b, mv1b=mv1b)
