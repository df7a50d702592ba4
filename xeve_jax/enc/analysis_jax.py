"""Device analysis stage (JAX): batched open-loop intra analysis.

This is the FLOP-heavy part of all-intra encoding: for every quadtree
level, predictions for all 5 Baseline modes of every block are formed at
once, transformed with constant-matrix matmuls, quantized,
inverse-transformed, and costed (distortion + bin-count rate estimate).
The partition DP runs on the tiny per-level cost maps.

Gather-free structure:
  - neighbour rows/cols come from strided slices + one roll/concat
  - scan-order statistics use a constant scan-rank matrix (elementwise max)
  - transforms are constant-matrix matmuls

Entry points configure the persistent compile cache (compile_cache.py)
before the first compile.

Numerics: decisions only (the closed-loop pass recomputes exact integers),
so f32 is sufficient; the numpy twin (analysis_np.py) is the exact-integer
golden reference and decision agreement is asserted in tests.  Every
matmul names its precision (MATMUL_PRECISION): at HIGHEST the device
computes in full f32, as the CPU tests do, instead of the TF32 or bf16 a
GPU backend may pick for an f32 product by default.
"""
from __future__ import annotations

import functools

import numpy as np
import jax

import jax.numpy as jnp

from ..constants import (TM, SCAN, QUANT_SCALE, DQUANT_SCALE_B,
                         MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT,
                         QUANT_IQUANT_SHIFT)
from .analysis_np import AnalysisResult, corrected_leaf

# numpy constants, so a graph traced for any backend embeds them
_TMf = {n: np.asarray(TM[n], dtype=np.float32) for n in TM}

# precision of every matmul in the analysis graphs (analysis_main_jax and
# winmc_jax import it)
MATMUL_PRECISION = jax.lax.Precision.HIGHEST
_P = MATMUL_PRECISION

# scan rank matrices: rank of raster position (v,u) in zigzag order
_SCAN_RANK = {}
for _n in (2, 4, 8, 16, 32, 64):
    _r = np.empty(_n * _n, dtype=np.float32)
    _r[SCAN[(_n, _n)]] = np.arange(_n * _n, dtype=np.float32)
    _SCAN_RANK[_n] = _r.reshape(_n, _n)


def _blocks(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).transpose(0, 2, 1, 3)


def _neighbors(plane, s, bd):
    """up (nby,nbx,2s), left (nby,nbx,2s), ul (nby,nbx) — slices/concat only."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    hc, wc = nby * s, nbx * s
    mid = np.float32(1 << (bd - 1))

    # up rows: row above each block row; block row 0 -> mid
    rows = plane[s - 1:hc - 1:s, :wc]                    # (nby-1, wc)
    rows = jnp.concatenate([jnp.full((1, wc), mid, plane.dtype), rows], axis=0)
    upA = rows.reshape(nby, nbx, s)                      # own up segment
    # next block's up segment (to the right); last -> mid
    upB = jnp.concatenate([upA[:, 1:, :],
                           jnp.full((nby, 1, s), mid, plane.dtype)], axis=1)
    up = jnp.concatenate([upA, upB], axis=2)             # (nby, nbx, 2s)

    cols = plane[:hc, s - 1:wc - 1:s]                    # (hc, nbx-1)
    cols = jnp.concatenate([jnp.full((hc, 1), mid, plane.dtype), cols], axis=1)
    leA = cols.T.reshape(nbx, nby, s).transpose(1, 0, 2)  # (nby, nbx, s)
    leB = jnp.concatenate([leA[1:, :, :],
                           jnp.full((1, nbx, s), mid, plane.dtype)], axis=0)
    left = jnp.concatenate([leA, leB], axis=2)           # (nby, nbx, 2s)

    ul = plane[s - 1:hc - 1:s, s - 1:wc - 1:s]           # (nby-1, nbx-1)
    ul = jnp.pad(ul, ((1, 0), (1, 0)), constant_values=mid)
    return up, left, ul


@functools.lru_cache(maxsize=None)
def _sel_matrices(s: int):
    """Constant one-hot selection matrices turning the UL/UR angular modes
    into matmuls: pred = SelUp @ up + SelLe @ left (+ mask * ul)."""
    n = s * s
    ul_up = np.zeros((n, 2 * s), np.float32)
    ul_le = np.zeros((n, 2 * s), np.float32)
    ul_c = np.zeros((s, s), np.float32)
    ur_up = np.zeros((n, 2 * s), np.float32)
    ur_le = np.zeros((n, 2 * s), np.float32)
    for i in range(s):
        for j in range(s):
            d = i - j
            p = i * s + j
            if d > 0:
                ul_le[p, d - 1] = 1.0
            elif d == 0:
                ul_c[i, j] = 1.0
            else:
                ul_up[p, -d - 1] = 1.0
            ur_up[p, i + j + 1] = 0.5
            ur_le[p, i + j + 1] = 0.5
    return ul_up, ul_le, ul_c, ur_up, ur_le


def _pred_all_modes(up, left, ul, s):
    nby, nbx, _ = up.shape
    dc = jnp.floor((left[:, :, :s].sum(-1) + up[:, :, :s].sum(-1) + s) / (2 * s))
    p_dc = jnp.broadcast_to(dc[:, :, None, None], (nby, nbx, s, s))
    p_hor = jnp.broadcast_to(left[:, :, :s, None], (nby, nbx, s, s))
    p_ver = jnp.broadcast_to(up[:, :, None, :s], (nby, nbx, s, s))
    ul_up, ul_le, ul_c, ur_up, ur_le = _sel_matrices(s)
    p_ul = (jnp.einsum('pk,yxk->yxp', ul_up, up, precision=_P) +
            jnp.einsum('pk,yxk->yxp', ul_le, left, precision=_P)) \
        .reshape(nby, nbx, s, s)
    p_ul = p_ul + ul_c[None, None] * ul[:, :, None, None]
    p_ur = (jnp.einsum('pk,yxk->yxp', ur_up, up, precision=_P) +
            jnp.einsum('pk,yxk->yxp', ur_le, left, precision=_P)) \
        .reshape(nby, nbx, s, s)
    p_ur = jnp.floor(p_ur)
    return jnp.stack([p_dc, p_hor, p_ver, p_ul, p_ur], axis=2)


def quant_params(qp: int, bd: int, log2s: int):
    """Host-side derivation of the dynamic quantizer parameters for one
    channel at one level: (q_scale, q_offset, q_div, dq_scale)."""
    scale = float(QUANT_SCALE[0][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = float(171 << (shift_q - 9))
    dq_scale = float(int(DQUANT_SCALE_B[qp % 6]) << (qp // 6))
    return scale, offset, float(1 << shift_q), dq_scale


def _tq_cost(orig_blocks, preds, qprm, bd, s):
    """(nby, nbx, 5) -> (dist, bits). f32 constant-matrix matmul pipeline.
    qprm: dynamic (4,) vector from quant_params (QP-independent graph)."""
    T = _TMf[s]
    log2s = int(np.log2(s))
    shift_fwd = (log2s - 1 + bd - 8) + (log2s + 6)
    q_scale, q_off, q_div, dq_scale = qprm[0], qprm[1], qprm[2], qprm[3]
    resi = orig_blocks[:, :, None, :, :] - preds
    c1 = jnp.einsum('vk,yxmkl->yxmvl', T, resi, precision=_P)
    coef = jnp.einsum('yxmvl,ul->yxmvu', c1, T, precision=_P)
    coef = jnp.floor((coef + (1 << (shift_fwd - 1))) / (1 << shift_fwd))
    lev = jnp.floor((jnp.abs(coef) * q_scale + q_off) / q_div)
    lev = jnp.minimum(lev, 32767.0)
    slev = jnp.sign(coef) * lev
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_dq = QUANT_IQUANT_SHIFT - QUANT_SHIFT - tr_shift
    dq = jnp.floor((slev * dq_scale + (1 << (shift_dq - 1))) / (1 << shift_dq))
    dq = jnp.clip(dq, -32768, 32767)
    shift_inv = 7 + (12 - (bd - 8))
    r1 = jnp.einsum('vk,yxmvu->yxmku', T, dq, precision=_P)
    resi_rec = jnp.floor((jnp.einsum('yxmku,un->yxmkn', r1, T,
                                     precision=_P) +
                          (1 << (shift_inv - 1))) / (1 << shift_inv))
    rec = jnp.clip(preds + resi_rec, 0, (1 << bd) - 1)
    dist = ((orig_blocks[:, :, None] - rec) ** 2).sum(axis=(-1, -2))

    # rate estimate without any gather: scan-rank constant matrix
    rank = _SCAN_RANK[s][None, None, None]
    nz = lev > 0
    nsig = nz.sum(axis=(-1, -2))
    last_idx = jnp.where(nsig > 0,
                         jnp.max(jnp.where(nz, rank, -1.0), axis=(-1, -2)),
                         -1.0)
    lev_bins = jnp.minimum(lev, 32.0).sum(axis=(-1, -2))
    from .analysis_np import BITS_SCALE
    bits = BITS_SCALE * ((last_idx + 1.0) + lev_bins + 2.0 * nsig) + 3.0
    bits = jnp.where(nsig == 0, 3.0, bits)
    return dist, bits


def level_params(qp: int, qp_y: int, qp_u: int, qp_v: int, bd: int, lg: int):
    """Dynamic (15,) parameter vector for one level: 3x quant_params + lam,
    w_u, w_v.  Computed host-side so the compiled graphs are QP-independent.
    """
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    p = (list(quant_params(qp_y, bd, lg)) +
         list(quant_params(qp_u, bd, lg - 1)) +
         list(quant_params(qp_v, bd, lg - 1)) + [lam, w_u, w_v])
    return np.asarray(p, dtype=np.float32)


def _level_cost_impl(orig_y, orig_u, orig_v, prm, bd, lg):
    s = 1 << lg
    sc = s >> 1
    oy = _blocks(orig_y, s)
    pY = _pred_all_modes(*_neighbors(orig_y, s, bd), s)
    dY, bY = _tq_cost(oy, pY, prm[0:4], bd, s)
    ou = _blocks(orig_u, sc)
    ov = _blocks(orig_v, sc)
    pU = _pred_all_modes(*_neighbors(orig_u, sc, bd), sc)
    pV = _pred_all_modes(*_neighbors(orig_v, sc, bd), sc)
    dU, bU = _tq_cost(ou, pU, prm[4:8], bd, sc)
    dV, bV = _tq_cost(ov, pV, prm[8:12], bd, sc)
    lam, w_u, w_v = prm[12], prm[13], prm[14]
    nby, nbx = dY.shape[:2]
    cost = (dY + w_u * dU[:nby, :nbx] + w_v * dV[:nby, :nbx] +
            lam * (bY + bU[:nby, :nbx] + bV[:nby, :nbx] + 3.0))
    return jnp.argmin(cost, axis=2).astype(jnp.int32), jnp.min(cost, axis=2)


_level_cost = jax.jit(_level_cost_impl, static_argnames=("bd", "lg"))


def _analyze_levels(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                    bd, min_log2, max_log2):
    out = {}
    for lg in range(min_log2, max_log2 + 1):
        prm = jnp.asarray(level_params(qp, qp_y, qp_u, qp_v, bd, lg))
        out[lg] = _level_cost(orig_y, orig_u, orig_v, prm, bd=bd, lg=lg)
    return out


@jax.jit
def _pack(parts):
    return jnp.concatenate([p.astype(jnp.float32).reshape(-1) for p in parts])


def _analyze_packed(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                    bd=10, min_log2=2, max_log2=6):
    """Per-level executables (fast, individually cached compiles) dispatched
    asynchronously, then one tiny concat executable so only ONE buffer
    crosses the device->host link."""
    res = _analyze_levels(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v,
                          bd, min_log2, max_log2)
    parts = []
    for lg in sorted(res):
        m, c = res[lg]
        parts.append(m)
        parts.append(c)
    return _pack(parts)


def _unpack(vec: np.ndarray, h: int, w: int, min_log2: int, max_log2: int):
    mode, leaf_cost = {}, {}
    off = 0
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        n = nby * nbx
        mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
        off += n
        leaf_cost[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.float64)
        off += n
    return mode, leaf_cost


def _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2):
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
    return AnalysisResult(mode=mode, split=split, leaf_cost=leaf_cost,
                          tree_cost=tree_cost)


def analyze_frame_jax(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                      max_log2=6, min_log2=2) -> AnalysisResult:
    """JAX analysis + host-side partition DP (tiny arrays)."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    h, w = orig_y.shape
    vec = _analyze_packed(jnp.asarray(orig_y, dtype=jnp.float32),
                          jnp.asarray(orig_u, dtype=jnp.float32),
                          jnp.asarray(orig_v, dtype=jnp.float32),
                          qp, qp_y, qp_u, qp_v,
                          bd=bd, min_log2=min_log2, max_log2=max_log2)
    mode, leaf_cost = _unpack(np.asarray(vec), h, w, min_log2, max_log2)
    return _partition_dp(mode, leaf_cost, h, w, lam, min_log2, max_log2)


# ---------------------------------------------------------------------------
# Batched analyzer: N independent frames per dispatch, one packed upload and
# one packed download per batch — amortizes the host<->device round trip and
# fills the device.
# ---------------------------------------------------------------------------


class BatchAnalyzer:
    def __init__(self, w: int, h: int, qp: int, qp_y: int, qp_u: int,
                 qp_v: int, bd: int = 10, min_log2: int = 2,
                 max_log2: int = 6):
        self.w, self.h = w, h
        self.qp, self.qp_y, self.qp_u, self.qp_v = qp, qp_y, qp_u, qp_v
        self.bd = bd
        self.min_log2, self.max_log2 = min_log2, max_log2
        self.lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        self.w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
        self.w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
        self.n_y = w * h
        self.n_c = (w // 2) * (h // 2)
        self._jit_cache = {}

    def _fn(self, batch: int):
        """Builds the per-batch pipeline as SEPARATE small executables (one
        per level) to keep compiles tractable: unpack -> level_2..6 -> pack.
        All dispatches are async; only the final packed buffer syncs."""
        if batch in self._jit_cache:
            return self._jit_cache[batch]
        w, h, bd = self.w, self.h, self.bd
        n_y, n_c = self.n_y, self.n_c

        def unpack_row(row):
            y = row[:n_y].reshape(h, w).astype(jnp.float32)
            u = row[n_y:n_y + n_c].reshape(h // 2, w // 2).astype(jnp.float32)
            v = row[n_y + n_c:].reshape(h // 2, w // 2).astype(jnp.float32)
            return y, u, v

        unpack_jit = jax.jit(jax.vmap(unpack_row))

        level_jits = {}
        prms = {}
        for lg in range(self.min_log2, self.max_log2 + 1):
            fn = functools.partial(_level_cost_impl, bd=bd, lg=lg)
            level_jits[lg] = jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, None)))
            prms[lg] = jnp.asarray(level_params(self.qp, self.qp_y, self.qp_u,
                                                self.qp_v, bd, lg))

        pack_jit = jax.jit(lambda parts: jnp.concatenate(
            [p.astype(jnp.float32).reshape(p.shape[0], -1) for p in parts],
            axis=1))

        def run(data):
            y, u, v = unpack_jit(data)
            parts = []
            for lg in range(self.min_log2, self.max_log2 + 1):
                m, c = level_jits[lg](y, u, v, prms[lg])
                parts.append(m)
                parts.append(c)
            return pack_jit(parts)

        self._jit_cache[batch] = run
        return run

    def analyze(self, frames) -> list[AnalysisResult]:
        """frames: list of (y, u, v) int arrays.  Returns AnalysisResults."""
        B = len(frames)
        data = np.empty((B, self.n_y + 2 * self.n_c), dtype=np.int16)
        for i, (y, u, v) in enumerate(frames):
            data[i, :self.n_y] = y.reshape(-1)
            data[i, self.n_y:self.n_y + self.n_c] = u.reshape(-1)
            data[i, self.n_y + self.n_c:] = v.reshape(-1)
        vecs = np.asarray(self._fn(B)(jnp.asarray(data)))
        out = []
        for i in range(B):
            mode, leaf_cost = _unpack(vecs[i], self.h, self.w,
                                      self.min_log2, self.max_log2)
            out.append(_partition_dp(mode, leaf_cost, self.h, self.w,
                                     self.lam, self.min_log2, self.max_log2))
        return out
