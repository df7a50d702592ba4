"""Device inter analysis (JAX): dense ME + subpel refinement + per-level costs.

Batched redesign of the reference's sequential per-CU inter analysis
(xeve_pinter.c:699 EPZS ME, :906 residue RDO):

  - integer ME is a dense full-search SAD reduction over the whole window
    (enc/me_jax.py, an XLA scan),
  - quarter-pel refinement interpolates the reference at all 16 sub-pel
    phases ONCE (separable 8-tap constant filters -> regular convolutions),
    then evaluates the 9+9 half/quarter-pel candidates for every 16x16
    block in parallel with per-block gathers from the phase planes,
  - per-quadtree-level prediction costs reuse the same phase planes.

Decisions only: the closed-loop coding pass (native C / FramePass)
recomputes exact MC and residuals, so small cost-model divergences from
the numpy oracle (chroma distortion uses nearest-pel chroma samples here)
change quality only, never conformance.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .analysis_inter_np import InterAnalysisResult, ME_BLK_LOG2
from .analysis_np import corrected_leaf
from .analysis_jax import analyze_frame_jax
from .me_jax import _me_int_jit

PAD = 64 + 16   # PIC_PAD_SIZE_L, matches api.py DPB padding

# xeve_tbl_mc_l_coeff rows 0/4/8/12 (xeve_mc.c:39)
_MC_L = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                  [0, 1, -5, 52, 20, -5, 1, 0],
                  [0, 2, -10, 40, 40, -10, 2, 0],
                  [0, 1, -5, 20, 52, -5, 1, 0]], dtype=np.int32)


def _interp_h(ext, co, shift):
    """8-tap filter along x of an edge-extended (+4 each side) plane;
    output width = input width - 8."""
    Wp = ext.shape[1] - 8
    acc = jnp.zeros_like(ext[:, :Wp])
    for k in range(8):
        acc = acc + co[k] * ext[:, 1 + k:1 + k + Wp]
    return acc >> shift


def _interp_v(ext, co, shift, off):
    Hp = ext.shape[0] - 8
    acc = jnp.full_like(ext[:Hp, :], off)
    for k in range(8):
        acc = acc + co[k] * ext[1 + k:1 + k + Hp, :]
    return acc >> shift


def _phase_planes(ref_pad, bd):
    """All 16 quarter-pel phase planes of a padded reference plane.
    Returns (16, Hp, Wp) int16 indexed [fy*4 + fx]; integer-exact
    xeve_mc.c semantics (single-direction shift 6 no offset; separable
    path truncates the intermediate to int16)."""
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    ext = jnp.pad(ref_pad.astype(jnp.int32), 4, mode="edge")
    planes = []
    # horizontal-filtered rows (kept row-extended for the vertical stage)
    h_full = {0: ext[:, 4:-4]}
    h_tmp16 = {}
    for fx in (1, 2, 3):
        h_full[fx] = _interp_h(ext, _MC_L[fx], 6)
        h_tmp16[fx] = _interp_h(ext, _MC_L[fx], shift1).astype(jnp.int16) \
                                                       .astype(jnp.int32)
    for fy in range(4):
        for fx in range(4):
            if fy == 0 and fx == 0:
                p = ext[4:-4, 4:-4]
            elif fy == 0:
                p = jnp.clip(h_full[fx][4:-4, :], 0, mx)
            elif fx == 0:
                p = jnp.clip(_interp_v(ext[:, 4:-4], _MC_L[fy], 6, 0), 0, mx)
            else:
                p = jnp.clip(_interp_v(h_tmp16[fx], _MC_L[fy], shift2, off2),
                             0, mx)
            planes.append(p.astype(jnp.int16))
    return jnp.stack(planes)


def _gather_blocks(planes, mv_q, s, pad, nby, nbx):
    """Per-block s x s windows at per-block quarter-pel MVs.
    planes: (16, Hp, Wp); mv_q: (nby, nbx, 2) qpel.  Returns int32
    (nby, nbx, s, s)."""
    Hp, Wp = planes.shape[1:]
    phase = mv_q & 3
    iv = mv_q >> 2
    pidx = phase[..., 1] * 4 + phase[..., 0]
    ar = jnp.arange(s)
    rows = (jnp.arange(nby) * s)[:, None, None] + ar[None, None, :] \
        + iv[..., 1][..., None] + pad
    cols = (jnp.arange(nbx) * s)[None, :, None] + ar[None, None, :] \
        + iv[..., 0][..., None] + pad
    rows = jnp.clip(rows, 0, Hp - 1)
    cols = jnp.clip(cols, 0, Wp - 1)
    g = planes[pidx[:, :, None, None], rows[:, :, :, None],
               cols[:, :, None, :]]
    return g.astype(jnp.int32)


def _cur_blocks(cur, s):
    h, w = cur.shape
    nby, nbx = h // s, w // s
    return cur[:nby * s, :nbx * s].reshape(nby, s, nbx, s).transpose(0, 2, 1, 3)


def _subpel_refine(cur16, planes, int_mv, pad):
    """Half-pel then quarter-pel 3x3 refinement for all 16x16 blocks in
    parallel (oracle: analysis_inter_np.subpel_refine; candidate order and
    strict-< tie-break preserved)."""
    nby, nbx = int_mv.shape[:2]
    best = int_mv.astype(jnp.int32) << 2
    best_sad = jnp.full((nby, nbx), jnp.iinfo(jnp.int32).max, jnp.int32)
    for step in (2, 1):
        center = best
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                cand = center + jnp.array([dx, dy], jnp.int32)
                g = _gather_blocks(planes, cand, 16, pad, nby, nbx)
                sad = jnp.abs(cur16 - g).sum(axis=(-1, -2)).astype(jnp.int32)
                upd = sad < best_sad
                best_sad = jnp.where(upd, sad, best_sad)
                best = jnp.where(upd[..., None], cand, best)
    return best


def _mv_for_level(mv16, lg, nby, nbx):
    """Per-level MV map (oracle: analysis_inter_np._mv_for_level)."""
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return jnp.repeat(jnp.repeat(mv16, f, axis=0), f,
                          axis=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m = mv16[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
    m = m.transpose(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
    return jnp.median(m, axis=2).astype(jnp.int32)


def _mvd_bits(mv_q):
    """(..., 2) qpel -> (...) bin-count (enc/syntax.py mvd_bits_est)."""
    a = jnp.abs(mv_q)
    nn = (a + 1) >> 1
    len_i = jnp.zeros_like(nn)
    for k in range(16):
        len_i = len_i + (nn >= (1 << k)).astype(nn.dtype)
    return (2 * len_i + 1 + (a > 0).astype(nn.dtype)).sum(-1)


@functools.partial(jax.jit,
                   static_argnames=("R", "bd", "pad", "min_log2", "max_log2"))
def _inter_costs_jit(orig_y, orig_u, orig_v, ref_y_pad, ref_u_pad, ref_v_pad,
                     prm, R: int, bd: int, pad: int, min_log2: int,
                     max_log2: int):
    """ME + subpel + per-level inter cost maps for one reference.
    prm: (3,) f32 = (lam, w_u, w_v).  Returns a packed f32 vector:
    per level [mv (nby,nbx,2), cost (nby,nbx)] then mv16 (for reuse)."""
    h, w = orig_y.shape
    nby16, nbx16 = h // 16, w // 16
    hc, wc = nby16 * 16, nbx16 * 16
    lam, w_u, w_v = prm[0], prm[1], prm[2]

    refc = jax.lax.dynamic_slice(
        ref_y_pad, (0, 0), (2 * pad + hc, 2 * pad + wc)).astype(jnp.float32)
    int_mv, _sad = _me_int_jit(orig_y[:hc, :wc].astype(jnp.float32), refc,
                               R, pad)

    planes = _phase_planes(ref_y_pad, bd)
    cur16 = _cur_blocks(orig_y.astype(jnp.int32), 16)
    mv16 = _subpel_refine(cur16, planes, int_mv, pad)

    parts = []
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        mv_l = _mv_for_level(mv16, lg, nby, nbx)
        g = _gather_blocks(planes, mv_l, s, pad, nby, nbx)
        cb = _cur_blocks(orig_y.astype(jnp.int32), s)
        d = ((cb - g) ** 2).sum(axis=(-1, -2)).astype(jnp.float32)
        # chroma distortion from nearest-pel chroma samples (analysis
        # heuristic; the coding pass recomputes exact chroma MC)
        sc = s >> 1
        ivc = (mv_l + 4) >> 3
        phase0 = jnp.zeros_like(ivc)
        mvc = (ivc << 2)            # integer chroma pels in "qpel" encoding
        del phase0
        gu = _gather_blocks(ref_u_pad.astype(jnp.int16)[None], mvc, sc,
                            pad // 2, nby, nbx)
        gv = _gather_blocks(ref_v_pad.astype(jnp.int16)[None], mvc, sc,
                            pad // 2, nby, nbx)
        cu = _cur_blocks(orig_u.astype(jnp.int32), sc)[:nby, :nbx]
        cv = _cur_blocks(orig_v.astype(jnp.int32), sc)[:nby, :nbx]
        du = ((cu - gu) ** 2).sum(axis=(-1, -2)).astype(jnp.float32)
        dv = ((cv - gv) ** 2).sum(axis=(-1, -2)).astype(jnp.float32)
        dall = d + w_u * du + w_v * dv
        bits = 8.0 + _mvd_bits(mv_l).astype(jnp.float32)
        cost = jnp.minimum(dall + lam * 4.0,
                           0.35 * dall + lam * (bits + 0.02 * jnp.sqrt(dall) * s))
        parts.append(mv_l.astype(jnp.float32).reshape(-1))
        parts.append(cost.reshape(-1))
    parts.append(mv16.astype(jnp.float32).reshape(-1))
    return jnp.concatenate(parts)


@functools.partial(jax.jit,
                   static_argnames=("R", "bd", "pad", "min_log2", "max_log2"))
def _mv_only_jit(orig_y, ref_y_pad, R: int, bd: int, pad: int,
                 min_log2: int, max_log2: int):
    """ME + subpel + per-level MV maps only (L1 of B slices: the oracle
    costs only L0)."""
    h, w = orig_y.shape
    nby16, nbx16 = h // 16, w // 16
    hc, wc = nby16 * 16, nbx16 * 16
    refc = jax.lax.dynamic_slice(
        ref_y_pad, (0, 0), (2 * pad + hc, 2 * pad + wc)).astype(jnp.float32)
    int_mv, _sad = _me_int_jit(orig_y[:hc, :wc].astype(jnp.float32), refc,
                               R, pad)
    planes = _phase_planes(ref_y_pad, bd)
    cur16 = _cur_blocks(orig_y.astype(jnp.int32), 16)
    mv16 = _subpel_refine(cur16, planes, int_mv, pad)
    parts = []
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        parts.append(_mv_for_level(mv16, lg, nby, nbx)
                     .astype(jnp.float32).reshape(-1))
    return jnp.concatenate(parts)


def analyze_frame_inter_jax(orig_y, orig_u, orig_v, refp, qp, qp_y, qp_u,
                            qp_v, bd, search_range=16, refp1=None,
                            max_log2=6, min_log2=2) -> InterAnalysisResult:
    """P/B-frame analysis on the device: intra level costs (analysis_jax) + dense
    inter level costs -> combined partition DP on the tiny cost maps."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    h, w = orig_y.shape
    R = int(search_range)

    intra = analyze_frame_jax(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                              bd, max_log2=max_log2, min_log2=min_log2)
    ref = refp[0]
    y_dev = jnp.asarray(np.asarray(orig_y, np.int32))
    u_dev = jnp.asarray(np.asarray(orig_u, np.int32))
    v_dev = jnp.asarray(np.asarray(orig_v, np.int32))
    prm = jnp.asarray(np.array([lam, w_u, w_v], np.float32))
    vec = np.asarray(_inter_costs_jit(
        y_dev, u_dev, v_dev,
        jnp.asarray(np.asarray(ref["y_pad"], np.int32)),
        jnp.asarray(np.asarray(ref["u_pad"], np.int32)),
        jnp.asarray(np.asarray(ref["v_pad"], np.int32)),
        prm, R=R, bd=bd, pad=PAD, min_log2=min_log2, max_log2=max_log2))

    mv1 = None
    if refp1 and refp1[0]["poc"] != ref["poc"]:
        vec1 = np.asarray(_mv_only_jit(
            y_dev, jnp.asarray(np.asarray(refp1[0]["y_pad"], np.int32)),
            R=R, bd=bd, pad=PAD, min_log2=min_log2, max_log2=max_log2))
        mv1 = {}
        off = 0
        for lg in range(min_log2, max_log2 + 1):
            s = 1 << lg
            nby, nbx = h // s, w // s
            mv1[lg] = vec1[off:off + nby * nbx * 2].reshape(nby, nbx, 2) \
                                                   .astype(np.int32)
            off += nby * nbx * 2

    mode, mv, leaf_cost = {}, {}, {}
    off = 0
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        mv[lg] = vec[off:off + nby * nbx * 2].reshape(nby, nbx, 2) \
                                             .astype(np.int32)
        off += nby * nbx * 2
        cost_i = vec[off:off + nby * nbx].reshape(nby, nbx).astype(np.float64)
        off += nby * nbx
        mode[lg] = intra.mode[lg]
        leaf_cost[lg] = np.minimum(intra.leaf_cost[lg], cost_i)
    if refp1 and mv1 is None:
        mv1 = {lg: mv[lg] for lg in mv}

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
                               tree_cost=tree_cost, mv=mv, mv1=mv1)
