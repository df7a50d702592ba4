"""Gather-free motion analysis primitives for the fused device analyzer.

Per-block advanced indexing (a gather per element) was the slow part of an
earlier subpel refinement; a one-hot matmul extraction of the same windows
replaced it.  Whether gathers or slicing would now be simpler and no
slower is an open question that a device trace decides (ROADMAP D8).

This module re-expresses the whole inter analysis pipeline with ZERO
per-element gathers:

  coarse_me        dense full-search at quarter resolution (lax.scan over
                   rows of the search window; the 4x downsample cuts the
                   72 G abs-diff ops of full-res search to ~0.3 G while
                   WIDENING the effective range to +-24 full-res pels)
  build_patches    static overlapping per-block patch tensors (stride =
                   block, window = block + 2*margin) by strided reshapes
  onehot_extract   per-block window extraction at data-dependent integer
                   offsets as two one-hot einsums (f32 at HIGHEST
                   precision, so 10-bit samples are exact)
  phase_windows    all 16 quarter-pel phase planes of each block window,
                   computed LOCALLY with static separable 8-tap filters
                   (integer-exact xeve_mc.c:39 semantics)
  eval_qpel        exhaustive SAD over the full +-8 qpel (+-2 pel)
                   candidate grid via static slices of the phase windows
                   — a quality superset of the reference's two-step
                   3x3 half/quarter pattern (xeve_pinter.c:553)
  perblock_mc      separable MC with per-block 12-tap filters (one-hot
                   over the 12 possible {int-offset, phase} combinations
                   per axis) — used to re-search large-CU MVs around the
                   median of their children (xeve_pinter.c:906 re-search
                   analog, fixing the median-only large-CU weakness)

Decisions only: the closed-loop native coding pass recomputes exact
integer costs, so analysis-side approximations change quality, never
conformance.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .analysis_jax import MATMUL_PRECISION

# xeve_tbl_mc_l_coeff rows 0/4/8/12 (xeve/src_base/xeve_mc.c:39)
MC_L = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                 [0, 1, -5, 52, 20, -5, 1, 0],
                 [0, 2, -10, 40, 40, -10, 2, 0],
                 [0, 1, -5, 20, 52, -5, 1, 0]], dtype=np.int32)

# Per-block {phase, int-offset} filter tables: row q - q_lo applies the
# 8-tap phase filter MC_L[q&3] at integer offset (q>>2) for qpel remainder
# q; out[r] = sum_t T[q][t] * W[r + t] with the output block origin at
# W row `origin` and taps placed at t = (origin - 3) + (q>>2) + j.
def _tap_table(q_lo: int, q_hi: int, origin: int):
    n_t = origin - 3 + (q_hi >> 2) + 8
    T = np.zeros((q_hi - q_lo + 1, n_t), np.int32)
    for q in range(q_lo, q_hi + 1):
        d = q >> 2
        f = q & 3
        for j in range(8):
            T[q - q_lo, origin - 3 + d + j] = MC_L[f, j]
    return T


# q in [-4, 7], window origin 5 (large-CU re-search on (s+12)-windows)
_T12 = _tap_table(-4, 7, 5)
# q in [-8, 8], window origin 7 (winner-prediction rebuild on 32-windows)
_T16 = _tap_table(-8, 8, 7)

# extraction precision: one-hot matmuls must be exact for 10-bit samples,
# which a bf16 (8-bit mantissa) or TF32 (10-bit mantissa) product rounds
_HI = MATMUL_PRECISION

MAX_MV_PEL = 23          # integer-pel MV clamp (patch margin 32 = 23+2+7)


def _ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# coarse motion search (quarter resolution, full search)
# ---------------------------------------------------------------------------


def _pool4(x):
    h, w = x.shape
    h4, w4 = h // 4, w // 4
    return x[:h4 * 4, :w4 * 4].reshape(h4, 4, w4, 4).sum(axis=(1, 3))


def coarse_me(cur_y_f32, ref_pad_f32, pad: int, nby: int, nbx: int,
              R4: int = 6):
    """Full-search ME at quarter resolution on the 4x4-pooled planes.
    cur (hc, wc) f32 with hc = nby*16; ref_pad edge-padded by `pad`.
    Returns (nby, nbx, 2) full-res integer MVs (multiples of 4 pels,
    clamped to +-MAX_MV_PEL), effective range +-4*R4 full-res pels."""
    hc, wc = nby * 16, nbx * 16
    cur4 = _pool4(cur_y_f32)                       # (nby*4, nbx*4)
    # pooled reference with R4+1 pooled-pel padding around the frame
    margin4 = R4 + 1
    r0 = pad - 4 * margin4
    ref_c = jax.lax.dynamic_slice(
        ref_pad_f32, (r0, r0), (hc + 8 * margin4, wc + 8 * margin4))
    ref4 = _pool4(ref_c)                           # (+2*margin4 each dim)
    H4, W4 = nby * 4, nbx * 4

    dxs = jnp.arange(-R4, R4 + 1)

    def row(carry, dy):
        best_sad, best_dx, best_dy = carry
        strip = jax.lax.dynamic_slice(ref4, (margin4 + dy, 0),
                                      (H4, W4 + 2 * margin4))
        cands = jnp.stack([strip[:, margin4 - R4 + i:margin4 - R4 + i + W4]
                           for i in range(2 * R4 + 1)])
        d = jnp.abs(cur4[None] - cands)
        # block = 4 pooled pels = 16 full-res
        sads = d.reshape(2 * R4 + 1, nby, 4, nbx, 4).sum(axis=(2, 4))
        reg = 4.0 * (jnp.abs(dxs)[:, None, None] + jnp.abs(dy)) \
            .astype(cur4.dtype)
        sads = sads + reg
        am = jnp.argmin(sads, axis=0)
        mn = jnp.min(sads, axis=0)
        upd = mn < best_sad
        best_sad = jnp.where(upd, mn, best_sad)
        best_dx = jnp.where(upd, dxs[am], best_dx)
        best_dy = jnp.where(upd, dy, best_dy)
        return (best_sad, best_dx, best_dy), None

    init = (jnp.full((nby, nbx), jnp.inf, cur4.dtype),
            jnp.zeros((nby, nbx), jnp.int32),
            jnp.zeros((nby, nbx), jnp.int32))
    (_, bdx, bdy), _ = jax.lax.scan(row, init, jnp.arange(-R4, R4 + 1))
    mv = jnp.stack([bdx, bdy], axis=-1) * 4
    return jnp.clip(mv, -MAX_MV_PEL, MAX_MV_PEL)


# ---------------------------------------------------------------------------
# patches + one-hot extraction
# ---------------------------------------------------------------------------


def build_patches(plane_pad, bs: int, k: int, off: int, nby: int, nbx: int,
                  pad: int):
    """(nby, nbx, k*bs, k*bs) int16 patches: patch[i,j,a,b] =
    plane_pad[pad + bs*i + a - off, pad + bs*j + b - off].  Static strided
    slicing only; requires off <= pad and (k*bs - off) <= pad + bs.
    Kept int16 (10-bit samples) — onehot_extract fuses the f32 convert
    into the matmul, halving the HBM footprint of the patch tensors."""
    win = k * bs
    plane_pad = plane_pad.astype(jnp.int16)
    Wp = plane_pad.shape[1]
    rows = []
    for sa in range(k):
        r0 = pad - off + bs * sa
        rows.append(jax.lax.dynamic_slice(
            plane_pad, (r0, 0), (nby * bs, Wp)).reshape(nby, bs, Wp))
    Pr = jnp.concatenate(rows, axis=1)             # (nby, win, Wp)
    cols = []
    for sb in range(k):
        c0 = pad - off + bs * sb
        cols.append(jax.lax.dynamic_slice(
            Pr, (0, 0, c0), (nby, win, nbx * bs)).reshape(nby, win, nbx, bs))
    P = jnp.concatenate(cols, axis=3)              # (nby, win, nbx, win)
    return P.transpose(0, 2, 1, 3)


def onehot_extract(P, off_r, off_c, oh: int, ow: int):
    """Extract (oh, ow) windows at per-block integer offsets (off_r, off_c)
    into the patch, as two one-hot matmuls.  P: (nby, nbx, win,
    win) int16; offsets (nby, nbx) int32 in [0, win - oh/ow]."""
    win = P.shape[-1]
    arr = jnp.arange(oh)
    arc = jnp.arange(ow)
    idx = jnp.arange(win)
    oh_r = (off_r[..., None, None] + arr[None, None, :, None]
            == idx[None, None, None, :]).astype(jnp.float32)
    oh_c = (off_c[..., None, None] + arc[None, None, :, None]
            == idx[None, None, None, :]).astype(jnp.float32)
    t = jnp.einsum('ijrk,ijkc->ijrc', oh_r, P.astype(jnp.float32),
                   precision=_HI)
    return jnp.einsum('ijrc,ijwc->ijrw', t, oh_c, precision=_HI)


# ---------------------------------------------------------------------------
# local quarter-pel phase windows (exact xeve_mc.c integer semantics)
# ---------------------------------------------------------------------------


def _hfilt(W, co, shift, lo, n):
    """8-tap filter along the last axis at output cols [lo, lo+n);
    taps at input offsets c-3..c+4.  W int32 (..., h, w)."""
    acc = None
    for kk in range(8):
        term = co[kk] * jax.lax.slice_in_dim(W, lo - 3 + kk, lo - 3 + kk + n,
                                             axis=-1)
        acc = term if acc is None else acc + term
    return acc >> shift


def _vfilt(W, co, shift, off, lo, n):
    acc = None
    for kk in range(8):
        term = co[kk] * jax.lax.slice_in_dim(W, lo - 3 + kk, lo - 3 + kk + n,
                                             axis=-2)
        acc = term if acc is None else acc + term
    return (acc + off) >> shift


def phase_windows(W32, bd: int, lo: int = 3, n: int = 24):
    """All 16 qpel phase planes of each (32, 32) block window, over window
    coords [lo, lo+n) x [lo, lo+n).  W32: (..., 32, 32) int32.  Returns
    (..., 16, n, n) int32, plane index fy*4+fx; integer-exact
    analysis_inter_jax._phase_planes semantics."""
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    co = MC_L
    # horizontal stage
    h_full = {0: jax.lax.slice_in_dim(W32, lo, lo + n, axis=-1)}
    h_tmp = {}
    for fx in (1, 2, 3):
        h_full[fx] = jnp.clip(_hfilt(W32, co[fx], 6, lo, n), 0, mx)
        t = _hfilt(W32, co[fx], shift1, lo, n)
        h_tmp[fx] = t.astype(jnp.int16).astype(jnp.int32)
    planes = []
    for fy in range(4):
        for fx in range(4):
            if fy == 0:
                p = jax.lax.slice_in_dim(h_full[fx], lo, lo + n, axis=-2)
            elif fx == 0:
                p = jnp.clip(_vfilt(W32, co[fy], 6, 0, lo, n)
                             [..., lo:lo + n], 0, mx)
            else:
                p = jnp.clip(_vfilt(h_tmp[fx], co[fy], shift2, off2, lo, n),
                             0, mx)
            planes.append(p.astype(jnp.int16))
    return jnp.stack(planes, axis=-3)


# ---------------------------------------------------------------------------
# exhaustive qpel candidate evaluation
# ---------------------------------------------------------------------------


def _cand_table(rng: int, lo: int, origin: int):
    """(n_cand,) arrays (qx, qy, pidx, r0, c0) for the qpel candidate grid,
    zero offset first so SAD ties favor it."""
    offs = [0] + [q for q in range(-rng, rng + 1) if q != 0]
    qx, qy, pidx, r0, c0 = [], [], [], [], []
    for oy in offs:
        for ox in offs:
            qx.append(ox)
            qy.append(oy)
            pidx.append((oy & 3) * 4 + (ox & 3))
            r0.append(origin + (oy >> 2) - lo)
            c0.append(origin + (ox >> 2) - lo)
    mk = lambda a: jnp.asarray(np.array(a, np.int32))
    return mk(qx), mk(qy), mk(pidx), mk(r0), mk(c0)


def eval_qpel(cur16, vw, rng: int = 8, lo: int = 3, origin: int = 7,
              want_pred: bool = True, W32=None, bd: int = 10):
    """Exhaustive SAD over the (2*rng+1)^2 qpel offsets in [-rng, rng]^2
    for every block, as a lax.scan over the candidate table (tiny compiled
    body; each step is a frame-sized SAD; carries are just sad + q so the
    scan streams no block-sized tensors).  cur16: (nby, nbx, 16, 16)
    int32; vw: (nby, nbx, 16, n, n) int16 phase windows with window coord
    `origin` = block start, planes offset by `lo`.  Returns (best_q
    (nby,nbx,2), best_sad, best_sq, best_pred); the winner's prediction is
    rebuilt AFTER the scan by one per-block-tap MC over the extraction
    windows W32 (None, None with want_pred=False)."""
    nby, nbx = cur16.shape[:2]
    tbl = jnp.stack(_cand_table(rng, lo, origin), axis=1)   # (n_cand, 5)

    def step(carry, row):
        qx, qy, pidx, r0, c0 = row[0], row[1], row[2], row[3], row[4]
        pred = jax.lax.dynamic_slice(
            vw, (0, 0, pidx, r0, c0), (nby, nbx, 1, 16, 16))[:, :, 0] \
            .astype(jnp.int32)
        sad = jnp.abs(cur16 - pred).sum(axis=(-1, -2))
        upd = sad < carry[0]
        best_sad = jnp.where(upd, sad, carry[0])
        best_q = jnp.where(upd[..., None], jnp.stack([qx, qy]), carry[1])
        return (best_sad, best_q), None

    init = (jnp.full((nby, nbx), jnp.int32(1 << 30)),
            jnp.zeros((nby, nbx, 2), jnp.int32))
    (best_sad, best_q), _ = jax.lax.scan(step, init, tbl)
    if not want_pred:
        return best_q, best_sad, None, None
    pred = perblock_mc(W32, best_q[..., 0], best_q[..., 1], 16, bd,
                       table=_T16, q_lo=-8)
    diff = cur16 - pred
    return best_q, best_sad, diff * diff, pred


def eval_qpel_target(target, vw, rng: int = 8, lo: int = 3, origin: int = 7):
    """eval_qpel against an arbitrary int32 target (bi refinement: target =
    2*cur - pred0, analyze_bi analog xeve_pinter.c:1567).  Returns best_q
    only."""
    nby, nbx = target.shape[:2]
    tbl = jnp.stack(_cand_table(rng, lo, origin), axis=1)

    def step(carry, row):
        best_cost, best_q = carry
        qx, qy, pidx, r0, c0 = row[0], row[1], row[2], row[3], row[4]
        pred = jax.lax.dynamic_slice(
            vw, (0, 0, pidx, r0, c0), (nby, nbx, 1, 16, 16))[:, :, 0] \
            .astype(jnp.int32)
        cost = jnp.abs(target - pred).sum(axis=(-1, -2))
        upd = cost < best_cost
        best_cost = jnp.where(upd, cost, best_cost)
        best_q = jnp.where(upd[..., None], jnp.stack([qx, qy]), best_q)
        return (best_cost, best_q), None

    init = (jnp.full((nby, nbx), jnp.int32(1 << 30)),
            jnp.zeros((nby, nbx, 2), jnp.int32))
    (_, best_q), _ = jax.lax.scan(step, init, tbl)
    return best_q


# ---------------------------------------------------------------------------
# per-block-tap MC (large-CU re-search around the children median)
# ---------------------------------------------------------------------------


def perblock_mc(Wext, q_rel_x, q_rel_y, s: int, bd: int,
                table=None, q_lo: int = -4):
    """Separable MC with per-block qpel remainders q_rel (int offset q>>2
    + phase q&3) selected per block via one-hot over the extended tap
    table (default _T12: q in [-4, 7] on (s+12)-windows with the output
    block origin at row/col 5; pass table=_T16, q_lo=-8 for q in [-8, 8]
    on 32-windows with origin 7).  out[r] = sum_t taps[t] * Wext[r + t]
    with no further origin shift (taps pre-placed by _tap_table).
    Returns (nby, nbx, s, s) int32 prediction (generic two-stage path for
    all phases — analysis cost only, <=1 LSB from the single-direction
    exact path)."""
    if table is None:
        table = _T12
    nq, nt = table.shape
    mx = (1 << bd) - 1
    shift1 = min(4, bd - 8)
    shift2 = max(8, 20 - bd)
    off2 = 1 << (shift2 - 1)
    tt = jnp.asarray(table)
    ohx = (q_rel_x[..., None] - q_lo == jnp.arange(nq)).astype(jnp.int32)
    ohy = (q_rel_y[..., None] - q_lo == jnp.arange(nq)).astype(jnp.int32)
    tx = jnp.einsum('ijq,qt->ijt', ohx, tt, precision=_HI)
    ty = jnp.einsum('ijq,qt->ijt', ohy, tt, precision=_HI)
    # horizontal over ALL rows (the v-stage needs every tap row), then
    # int16 truncation, then vertical
    tmp = None
    for t in range(nt):
        sl = jax.lax.slice_in_dim(Wext, t, t + s, axis=-1)
        term = tx[..., None, None, t] * sl
        tmp = term if tmp is None else tmp + term
    tmp = (tmp >> shift1).astype(jnp.int16).astype(jnp.int32)
    out = None
    for t in range(nt):
        sl = jax.lax.slice_in_dim(tmp, t, t + s, axis=-2)
        term = ty[..., None, None, t] * sl
        out = term if out is None else out + term
    return jnp.clip((out + off2) >> shift2, 0, mx)
