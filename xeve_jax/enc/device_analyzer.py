"""Fused single-dispatch device analyzer with a device-resident
original-frame ring.

The per-frame analysis stage is built to keep host<->device round trips
and transfers few and small, and the device busy:

  - every original frame is uploaded ONCE (int16) and kept in a device
    ring keyed by POC; motion estimation runs against *original* frames
    (the reference's lookahead does the same at half resolution,
    xeve_fcst.c:1000) so analysis never depends on reconstructed pixels
    and can run arbitrarily far ahead of the closed-loop coding pass,
  - one fused jit per frame computes the intra level costs, dense ME +
    quarter-pel refinement + per-level inter costs, and the partition DP
    ON DEVICE (SURVEY.md section 7.1 batch-everything),
  - exactly ONE device->host transfer per frame: a small packed int16
    decision vector (modes, splits, 16x16 MV field).

The closed-loop native coding pass (native/xt_core.c) re-evaluates
skip/direct/inter/intra with exact integer costs against the true
reconstructed references, so analysis-side approximations (open-loop ME,
f32 cost model) affect quality only, never conformance.

Reference counterparts: xeve_pinter.c:699 (EPZS ME), xeve_mode.c:2007
(recursive RDO tree) — both re-expressed as dense batched tensor work.
"""
from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from .analysis_jax import _level_cost_impl, level_params
from .analysis_inter_jax import _cur_blocks, _mvd_bits
from .analysis_inter_np import InterAnalysisResult, ME_BLK_LOG2
from .analysis_np import corrected_leaf, AnalysisResult
from . import winmc_jax as wm

PAD = 64 + 16   # matches api.py DPB padding (PIC_PAD_SIZE_L)

log = logging.getLogger(__name__)

# large-CU re-search candidate offsets (qpel) around the children median,
# per axis (xeve_pinter.c:906 per-CU refinement analog)
RESEARCH_OFFS = (-4, -2, -1, 0, 1, 2, 4)


def _ceil_div(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# shared (device + host twin) per-level MV derivation from the padded
# 16x16 MV field.  mv16c covers the CEIL grid (edge-replicated), so every
# level's map is fully defined even for non-16-multiple frame sizes.
# ---------------------------------------------------------------------------


def _mv_for_level_dev(mv16c, lg, nby, nbx):
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return jnp.repeat(jnp.repeat(mv16c, f, axis=0), f,
                          axis=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m = mv16c[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
    m = m.transpose(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
    return jnp.median(m, axis=2).astype(jnp.int32)


def _mv_for_level_np(mv16c, lg, nby, nbx):
    if lg <= ME_BLK_LOG2:
        f = 1 << (ME_BLK_LOG2 - lg)
        return np.repeat(np.repeat(mv16c, f, axis=0), f, axis=1)[:nby, :nbx]
    f = 1 << (lg - ME_BLK_LOG2)
    m = mv16c[:nby * f, :nbx * f].reshape(nby, f, nbx, f, 2)
    m = m.transpose(0, 2, 1, 3, 4).reshape(nby, nbx, f * f, 2)
    return np.median(m, axis=2).astype(np.int32)


# ---------------------------------------------------------------------------
# fused device graph
# ---------------------------------------------------------------------------


def _boxsum(plane, s):
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).sum(axis=(1, 3))


def _assemble(blocks):
    """(nby, nbx, s, s) -> (nby*s, nbx*s) plane."""
    nby, nbx, s, _ = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(nby * s, nbx * s)


def _pad_to(plane, h, w):
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph or pw:
        plane = jnp.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


def _ref_luma(y_i32, ref_y16, pad, bd, h, w, want_pred: bool = True):
    """Coarse quarter-res ME + exhaustive +-8 qpel window refinement for
    one reference (winmc_jax pipeline, zero gathers).  Returns (mv16c
    ceil-grid qpel MV field, vw phase windows, sq16 squared-diff blocks,
    pred16 winning predictions, ry_pad padded int32 ref, m coarse int
    MVs).  want_pred=False drops the sq/pred scan carries (MV-only
    auxiliary reference planes)."""
    nby16, nbx16 = h // 16, w // 16
    hc, wc = nby16 * 16, nbx16 * 16
    ry_pad = jnp.pad(ref_y16.astype(jnp.int32), pad, mode="edge")
    m = wm.coarse_me(y_i32[:hc, :wc].astype(jnp.float32),
                     ry_pad.astype(jnp.float32), pad, nby16, nbx16)
    P16 = wm.build_patches(ry_pad, 16, 5, 32, nby16, nbx16, pad)
    W32 = wm.onehot_extract(P16, m[..., 1] + 25, m[..., 0] + 25,
                            32, 32).astype(jnp.int32)
    vw = wm.phase_windows(W32, bd)
    cur16 = _cur_blocks(y_i32, 16)
    q, _sad, sq16, pred16 = wm.eval_qpel(cur16, vw, want_pred=want_pred,
                                         W32=W32, bd=bd)
    mv16 = 4 * m + q
    py = _ceil_div(h, 16) - nby16
    px = _ceil_div(w, 16) - nbx16
    mv16c = jnp.pad(mv16, ((0, py), (0, px), (0, 0)), mode="edge")
    return mv16c, vw, sq16, pred16, ry_pad, m


def _chroma_pred8(ref_c16, mvc, pad_c, nby, nbx):
    """Nearest-pel 8x8 chroma predictions at per-block integer chroma MVs
    via patch extraction (analysis heuristic; the coding pass recomputes
    exact chroma MC)."""
    rc_pad = jnp.pad(ref_c16.astype(jnp.int32), pad_c, mode="edge")
    Pc = wm.build_patches(rc_pad, 8, 5, 16, nby, nbx, pad_c)
    return wm.onehot_extract(Pc, mvc[..., 1] + 16, mvc[..., 0] + 16,
                             8, 8).astype(jnp.int32)


def _research_level(y_i32, ry_pad, mv16c, lg, bd, pad, h, w):
    """Large-CU MV re-search: evaluate RESEARCH_OFFS^2 qpel offsets around
    the children-median MV with per-block-tap MC, per CU.  Returns
    (mv_l researched (nby,nbx,2), dY best luma SSD (nby,nbx))."""
    s = 1 << lg
    nby, nbx = h // s, w // s
    mv_med = jnp.clip(_mv_for_level_dev(mv16c, lg, nby, nbx), -92, 92)
    bv = mv_med >> 2
    phi = mv_med & 3
    k = {5: 3, 6: 2}[lg]
    P = wm.build_patches(ry_pad, s, k, 32, nby, nbx, pad)
    Wext = wm.onehot_extract(P, bv[..., 1] + 27, bv[..., 0] + 27,
                             s + 12, s + 12).astype(jnp.int32)
    cur = _cur_blocks(y_i32, s)[:nby, :nbx]
    offs = jnp.asarray(np.array(
        [(dx, dy) for dy in RESEARCH_OFFS for dx in RESEARCH_OFFS
         if not (dx == 0 and dy == 0)], np.int32))

    # zero offset first (tie-favored), then scan the rest
    pred0 = wm.perblock_mc(Wext, phi[..., 0], phi[..., 1], s, bd)
    best_d = ((cur - pred0) ** 2).sum(axis=(-1, -2))
    best_off = jnp.zeros((nby, nbx, 2), jnp.int32)

    def step(carry, off):
        best_d, best_off = carry
        pred = wm.perblock_mc(Wext, phi[..., 0] + off[0],
                              phi[..., 1] + off[1], s, bd)
        d = ((cur - pred) ** 2).sum(axis=(-1, -2))
        upd = d < best_d
        best_d = jnp.where(upd, d, best_d)
        best_off = jnp.where(upd[..., None], off, best_off)
        return (best_d, best_off), None

    (best_d, best_off), _ = jax.lax.scan(step, (best_d, best_off), offs)
    return mv_med + best_off, best_d


def _chroma_ssd_level(u_i32, v_i32, ru_pad, rv_pad, mv_l, lg, pad_c, h, w):
    """Nearest-pel chroma SSD for one large-CU level at the (researched)
    MVs, via per-level chroma patches."""
    s = 1 << lg
    sc = s >> 1
    nby, nbx = h // s, w // s
    mvc = (mv_l + 4) >> 3
    k = {5: 3, 6: 2}[lg]
    Pu = wm.build_patches(ru_pad, sc, k, 16, nby, nbx, pad_c)
    Pv = wm.build_patches(rv_pad, sc, k, 16, nby, nbx, pad_c)
    gu = wm.onehot_extract(Pu, mvc[..., 1] + 16, mvc[..., 0] + 16,
                           sc, sc).astype(jnp.int32)
    gv = wm.onehot_extract(Pv, mvc[..., 1] + 16, mvc[..., 0] + 16,
                           sc, sc).astype(jnp.int32)
    cu = _cur_blocks(u_i32, sc)[:nby, :nbx]
    cv = _cur_blocks(v_i32, sc)[:nby, :nbx]
    du = ((cu - gu) ** 2).sum(axis=(-1, -2)).astype(jnp.float32)
    dv = ((cv - gv) ** 2).sum(axis=(-1, -2)).astype(jnp.float32)
    return du, dv


def _inter_costs_v2(y_i32, u_i32, v_i32, ref0, mv16c, sq16, ry_pad, prm3,
                    pad, min_log2, max_log2, h, w, bd):
    """Per-level inter cost maps (same cost model as round 3) built from
    diff-plane box sums (levels <= 4, children MVs == their 16x16 parent)
    and per-CU re-searched MVs (levels 5/6).  Returns (costs dict,
    researched dict lg -> (nby,nbx,2))."""
    lam, w_u, w_v = prm3[0], prm3[1], prm3[2]
    nby16, nbx16 = h // 16, w // 16
    pad_c = pad // 2
    mv16f = mv16c[:nby16, :nbx16]
    mvc8 = (mv16f + 4) >> 3
    gu8 = _chroma_pred8(ref0[1], mvc8, pad_c, nby16, nbx16)
    gv8 = _chroma_pred8(ref0[2], mvc8, pad_c, nby16, nbx16)
    cu8 = _cur_blocks(u_i32, 8)[:nby16, :nbx16]
    cv8 = _cur_blocks(v_i32, 8)[:nby16, :nbx16]
    sqY = _pad_to(_assemble(sq16), h, w).astype(jnp.float32)
    sqU = _pad_to(_assemble((cu8 - gu8) ** 2), h // 2, w // 2) \
        .astype(jnp.float32)
    sqV = _pad_to(_assemble((cv8 - gv8) ** 2), h // 2, w // 2) \
        .astype(jnp.float32)

    ru_pad = jnp.pad(ref0[1].astype(jnp.int32), pad_c, mode="edge")
    rv_pad = jnp.pad(ref0[2].astype(jnp.int32), pad_c, mode="edge")

    costs, researched = {}, {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        nby, nbx = h // s, w // s
        if nby == 0 or nbx == 0:
            costs[lg] = jnp.full((nby, nbx), jnp.inf, jnp.float32)
            continue
        if lg <= 4:
            dall = (_boxsum(sqY, s) + w_u * _boxsum(sqU, s >> 1)
                    + w_v * _boxsum(sqV, s >> 1))
            mv_l = _mv_for_level_dev(mv16c, lg, nby, nbx)
        else:
            mv_l, dY = _research_level(y_i32, ry_pad, mv16c, lg, bd=bd,
                                       pad=pad, h=h, w=w)
            du, dv = _chroma_ssd_level(u_i32, v_i32, ru_pad, rv_pad, mv_l,
                                       lg, pad_c, h, w)
            dall = dY.astype(jnp.float32) + w_u * du + w_v * dv
            researched[lg] = mv_l
        bits = 8.0 + _mvd_bits(mv_l).astype(jnp.float32)
        costs[lg] = jnp.minimum(
            dall + lam * 4.0,
            0.35 * dall + lam * (bits + 0.02 * jnp.sqrt(dall) * s))
    return costs, researched


def _partition_dp_dev(leaf_cost, lam, h, w, min_log2, max_log2):
    split = {min_log2: jnp.zeros_like(leaf_cost[min_log2], dtype=jnp.int16)}
    tree = corrected_leaf(min_log2, leaf_cost[min_log2])
    for lg in range(min_log2 + 1, max_log2 + 1):
        s = 1 << lg
        nby, nbx = leaf_cost[lg].shape
        ch = tree[:nby * 2, :nbx * 2]
        sum4 = ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] + ch[1::2, 1::2]
        ys = (np.arange(nby) + 1) * s
        xs = (np.arange(nbx) + 1) * s
        valid = jnp.asarray((ys[:, None] <= h) & (xs[None, :] <= w))
        leafc = jnp.where(valid, corrected_leaf(lg, leaf_cost[lg]), jnp.inf)
        sp = sum4 + lam < leafc
        split[lg] = sp.astype(jnp.int16)
        tree = jnp.where(sp, sum4 + lam, leafc)
    return split


def _fused_impl(y16, u16, v16, ref0, ref0b, ref1, ref1b, prms, prm3, *,
                bd, R, pad, min_log2, max_log2, refine):
    """refs: (y16,u16,v16) originals or None — ref0/ref0b are L0 refi 0/1,
    ref1/ref1b are L1 refi 0/1 (multi-ref per xeve_picman.c:271 lists).
    prms: (n_levels, 15) per-level quant params; prm3: (3,) lam/w_u/w_v.
    Returns one packed int16 vector: mode/split per level, then the 16x16
    qpel MV planes for each present ref in order [L0r0, L0r1, L1r0, L1r1,
    bi-refined L1], with the re-searched large-CU MV maps (levels 5/6)
    for the L0r0 plane right after its 16x16 field.  R is kept in the
    signature for dispatch compatibility; the effective search range is
    the coarse quarter-res window (+-24 pel, clamped +-23)."""
    del R
    h, w = y16.shape
    yf = y16.astype(jnp.float32)
    uf = u16.astype(jnp.float32)
    vf = v16.astype(jnp.float32)
    y_i32 = y16.astype(jnp.int32)
    u_i32 = u16.astype(jnp.int32)
    v_i32 = v16.astype(jnp.int32)
    lam = prm3[0]

    mode, leaf = {}, {}
    for i, lg in enumerate(range(min_log2, max_log2 + 1)):
        m, c = _level_cost_impl(yf, uf, vf, prms[i], bd, lg)
        mode[lg] = m
        leaf[lg] = c

    mv16c = mv16c_0b = mv16c_1 = mv16c_1b = mv16c_bi = None
    researched = {}
    pred16_0 = vw1 = m1 = None
    if ref0 is not None:
        mv16c, _vw0, sq16, pred16_0, ry0, _m0 = _ref_luma(
            y_i32, ref0[0], pad, bd, h, w)
        icosts, researched = _inter_costs_v2(
            y_i32, u_i32, v_i32, ref0, mv16c, sq16, ry0, prm3, pad,
            min_log2, max_log2, h, w, bd)
        for lg in leaf:
            leaf[lg] = jnp.minimum(leaf[lg], icosts[lg])
    if ref0b is not None:
        mv16c_0b = _ref_luma(y_i32, ref0b[0], pad, bd, h, w,
                             want_pred=False)[0]
    if ref1 is not None:
        mv16c_1, vw1, _sq1, _p1, _ry1, m1 = _ref_luma(
            y_i32, ref1[0], pad, bd, h, w, want_pred=False)
    if ref1b is not None:
        mv16c_1b = _ref_luma(y_i32, ref1b[0], pad, bd, h, w,
                             want_pred=False)[0]
    if refine and ref0 is not None and ref1 is not None:
        # joint bi refinement (analyze_bi analog): re-search L1 around its
        # coarse center against the L0-compensated residual target
        cur16 = _cur_blocks(y_i32, 16)
        tgt = 2 * cur16 - pred16_0
        qbi = wm.eval_qpel_target(tgt, vw1)
        nby16, nbx16 = h // 16, w // 16
        mvbi = 4 * m1 + qbi
        py = _ceil_div(h, 16) - nby16
        px = _ceil_div(w, 16) - nbx16
        mv16c_bi = jnp.pad(mvbi, ((0, py), (0, px), (0, 0)), mode="edge")

    split = _partition_dp_dev(leaf, lam, h, w, min_log2, max_log2)

    parts = []
    for lg in range(min_log2, max_log2 + 1):
        parts.append(mode[lg].astype(jnp.int16).reshape(-1))
        parts.append(split[lg].reshape(-1))
    for i, m in enumerate((mv16c, mv16c_0b, mv16c_1, mv16c_1b, mv16c_bi)):
        if m is not None:
            parts.append(m.astype(jnp.int16).reshape(-1))
        if i == 0:
            for lg in sorted(researched):
                parts.append(researched[lg].astype(jnp.int16).reshape(-1))
    # RC complexity: total best-mode cost at the 16x16 level, packed as
    # two int16 halves of a >>16-scaled int32 — the one scalar the
    # frame-level rate model consumes (replaces the host Hadamard proxy)
    rci = jnp.clip(leaf[4].sum() / 65536.0, 0, 2.0 ** 30).astype(jnp.int32)
    parts.append(jnp.stack([(rci >> 15).astype(jnp.int16),
                            (rci & 0x7fff).astype(jnp.int16)]))
    return jnp.concatenate(parts)


_fused_jit = jax.jit(_fused_impl,
                     static_argnames=("bd", "R", "pad", "min_log2",
                                      "max_log2", "refine"))


def fused_params(qp, qp_y, qp_u, qp_v, bd, min_log2, max_log2):
    """Host-side dynamic parameters of _fused_impl: (prms (n_levels, 15),
    prm3 (3,) = lam, w_u, w_v), both f32."""
    prms = np.stack([level_params(qp, qp_y, qp_u, qp_v, bd, lg)
                     for lg in range(min_log2, max_log2 + 1)])
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    return prms, np.array([lam, w_u, w_v], np.float32)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------


class _Handle:
    """kind: 'I' | 'P' | 'B' (legacy) — or pass `planes`, a 5-tuple of
    bools (L0r0, L0r1, L1r0, L1r1, bi-refined) saying which MV planes the
    packed vector carries.  `args` keeps the dispatch arguments for
    failure recovery (re-dispatch / host fallback)."""
    __slots__ = ("vec", "kind", "h", "w", "min_log2", "max_log2", "planes",
                 "args")

    def __init__(self, vec, kind, h, w, min_log2, max_log2, planes=None,
                 args=None):
        self.vec = vec
        self.kind = kind
        self.h, self.w = h, w
        self.min_log2, self.max_log2 = min_log2, max_log2
        if planes is None:
            planes = {"I": (False,) * 5,
                      "P": (True, False, False, False, False),
                      "B": (True, False, True, False, False)}[kind]
        self.planes = planes
        self.args = args


class DeviceAnalyzer:
    """Original-frame ring + fused per-frame analysis dispatch.

    dispatch() is asynchronous (returns a handle immediately; the device
    computes in the background); collect() blocks on the single packed
    transfer and materializes the decision maps."""

    def __init__(self, w: int, h: int, bd: int = 10, search_range: int = 16,
                 min_log2: int = 2, max_log2: int = 6, ring_size: int = 24):
        if bd not in (8, 10):
            raise ValueError("device analyzer supports 8/10-bit internal")
        self.w, self.h, self.bd = w, h, bd
        self.R = int(search_range)
        self.min_log2, self.max_log2 = min_log2, max_log2
        self.ring: dict[int, tuple] = {}
        self.host_ring: dict[int, tuple] = {}
        self.ring_size = ring_size
        self.failures = 0          # recovered device failures (telemetry)
        self._pool = None          # lazy single-thread dispatcher

    def _submit(self, fn, *args, **kw):
        """Run device work on the single dispatcher thread.  The runtime
        bounds in-flight device computations, so an enqueue past the limit
        BLOCKS — on this thread, never on the main thread driving the
        native coding pass (measured: a 16-deep sub-GOP dispatch burst
        blocked dispatch() for ~325 ms/frame, fully serializing analysis
        against the C pass)."""
        if self._pool is None:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="xt-dispatch")
        return self._pool.submit(fn, *args, **kw)

    # -- frame ring ------------------------------------------------------
    def put_frame(self, poc: int, y, u, v, replace: bool = False):
        """Upload one original frame (async, via the dispatcher thread).
        Arrays must be the aligned coded size.  A host-side copy is kept
        for failure recovery (SURVEY.md §5.3: the device can die
        mid-encode; analysis falls back to the numpy oracle from host
        originals).  Re-puts of a POC already resident are no-ops so
        callers can stream uploads at frame-arrival time (overlapping the
        previous sub-GOP's coding pass) and the sub-GOP dispatch loop can
        still put defensively.  replace=True overwrites a resident POC —
        the closed-loop LD mode swaps originals for reconstructions so
        P-chain analysis references what the decoder will actually see."""
        if poc in self.host_ring and not replace:
            return
        hy = np.asarray(y, np.int16)
        hu = np.asarray(u, np.int16)
        hv = np.asarray(v, np.int16)
        self.host_ring[poc] = (hy, hu, hv)
        if len(self.host_ring) > self.ring_size:
            for k in sorted(self.host_ring)[:len(self.host_ring)
                                            - self.ring_size]:
                del self.host_ring[k]
        self._submit(self._upload, poc, hy, hu, hv)

    def _upload(self, poc, hy, hu, hv):
        self.ring[poc] = (jnp.asarray(hy), jnp.asarray(hu), jnp.asarray(hv))
        if len(self.ring) > self.ring_size:
            for k in sorted(self.ring)[:len(self.ring) - self.ring_size]:
                del self.ring[k]

    def has_frame(self, poc: int) -> bool:
        return poc in self.host_ring

    def ring_get(self, poc: int):
        """Device arrays for a resident POC.  When called off the
        dispatcher thread before its queued upload ran, falls back to a
        synchronous upload (same content; a late queued upload just
        overwrites with an identical copy)."""
        t = self.ring.get(poc)
        if t is None:
            hy, hu, hv = self.host_ring[poc]
            t = (jnp.asarray(hy), jnp.asarray(hu), jnp.asarray(hv))
            self.ring[poc] = t
        return t

    # -- analysis --------------------------------------------------------
    def dispatch(self, poc: int, qp: int, qp_y: int, qp_u: int, qp_v: int,
                 ref_poc: int | None = None,
                 ref1_poc: int | None = None,
                 ref0b_poc: int | None = None,
                 ref1b_poc: int | None = None,
                 bi_refine: bool = True) -> _Handle:
        """bi_refine defaults ON since the round-4 gather-free rewrite:
        the joint refinement reuses the L1 phase windows already computed
        for its ME, so it costs one extra 289-candidate scan (~2 ms at
        1080p) instead of a second full gather pass."""
        y, u, v = self.ring_get(poc)
        kind = "I" if ref_poc is None else (
            "B" if (ref1_poc is not None and ref1_poc != ref_poc) else "P")
        prms, prm3 = fused_params(qp, qp_y, qp_u, qp_v, self.bd,
                                  self.min_log2, self.max_log2)
        prms, prm3 = jnp.asarray(prms), jnp.asarray(prm3)
        ref0 = self.ring_get(ref_poc) if kind in ("P", "B") else None
        ref1 = self.ring_get(ref1_poc) if kind == "B" else None
        ref0b = (self.ring_get(ref0b_poc)
                 if (kind != "I" and ref0b_poc is not None
                     and ref0b_poc in self.host_ring) else None)
        ref1b = (self.ring_get(ref1b_poc)
                 if (kind == "B" and ref1b_poc is not None
                     and ref1b_poc in self.host_ring) else None)
        refine = bool(bi_refine and kind == "B")
        vec = _fused_jit(y, u, v, ref0, ref0b, ref1, ref1b, prms, prm3,
                         bd=self.bd, R=self.R, pad=PAD,
                         min_log2=self.min_log2, max_log2=self.max_log2,
                         refine=refine)
        planes = (ref0 is not None, ref0b is not None, ref1 is not None,
                  ref1b is not None, refine)
        return _Handle(vec, kind, self.h, self.w, self.min_log2,
                       self.max_log2, planes=planes,
                       args=(poc, qp, qp_y, qp_u, qp_v, ref_poc, ref1_poc,
                             ref0b_poc, ref1b_poc, bi_refine))

    # -- failure recovery (SURVEY.md §5.3) -------------------------------
    def _redispatch(self, hd: _Handle) -> _Handle:
        """Re-upload the involved originals from the host ring and re-run
        the dispatch (device restart / preemption recovery)."""
        poc, _, _, _, _, r0, r1, r0b, r1b, _ = hd.args
        for q in (poc, r0, r1, r0b, r1b):
            if q is not None and q in self.host_ring:
                y, u, v = self.host_ring[q]
                self.ring[q] = (jnp.asarray(y), jnp.asarray(u),
                                jnp.asarray(v))
        return self.dispatch(*hd.args)

    def _host_fallback(self, hd: _Handle):
        """Device unrecoverable: compute this frame's analysis with the
        numpy oracle from the host-side original ring so the encode
        continues CPU-only."""
        from .analysis_np import analyze_frame
        from .analysis_inter_np import analyze_frame_inter
        from ..ops import mc_np
        poc, qp, qp_y, qp_u, qp_v, r0, r1, r0b, r1b, _ = hd.args
        y, u, v = [np.asarray(p, np.int32) for p in self.host_ring[poc]]
        if r0 is None:
            return analyze_frame(y, u, v, qp, qp_y, qp_u, qp_v, self.bd,
                                 min_log2=self.min_log2)

        def ref(q):
            ry, ru, rv = self.host_ring[q]
            return {"poc": q,
                    "y_pad": mc_np.pad_picture(np.asarray(ry, np.int32),
                                               PAD),
                    "u_pad": mc_np.pad_picture(np.asarray(ru, np.int32),
                                               PAD // 2),
                    "v_pad": mc_np.pad_picture(np.asarray(rv, np.int32),
                                               PAD // 2)}
        refp = [ref(r0)] + ([ref(r0b)] if r0b is not None else [])
        refp1 = None
        if r1 is not None and r1 != r0:
            refp1 = [ref(r1)] + ([ref(r1b)] if r1b is not None else [])
        return analyze_frame_inter(y, u, v, refp, qp, qp_y, qp_u, qp_v,
                                   self.bd, search_range=self.R,
                                   refp1=refp1, min_log2=self.min_log2)

    def dispatch_bg(self, *args, **kw):
        """dispatch() on the dispatcher thread; returns a Future[_Handle]
        that collect() accepts.  Keeps runtime enqueue backpressure (the
        bounded in-flight computation limit) off the thread running the
        native coding pass."""
        return self._submit(self.dispatch, *args, **kw)

    def collect(self, hd):
        """Block on the packed transfer; build the decision maps the coding
        pass consumes (split/mode per level, per-level MV maps).  Accepts
        a _Handle or a dispatch_bg Future.  On a device failure: one
        re-dispatch, then the numpy-oracle fallback — the encode never
        dies with the device.  Each recovery is logged as a warning and
        counted in `failures`."""
        if hasattr(hd, "result"):
            hd = hd.result()
        try:
            vec = np.asarray(hd.vec)
        except Exception as e:
            self.failures += 1
            if hd.args is None:
                raise
            log.warning("device analysis of poc %d failed (%r); "
                        "re-dispatching", hd.args[0], e)
            try:
                hd = self._redispatch(hd)
                vec = np.asarray(hd.vec)
            except Exception as e2:
                log.warning("re-dispatch of poc %d failed (%r); analysing "
                            "it with the numpy oracle on the host",
                            hd.args[0], e2)
                return self._host_fallback(hd)
        return self._parse(hd, vec)

    def _parse(self, hd: _Handle, vec):
        h, w = hd.h, hd.w
        mode, split = {}, {}
        off = 0
        for lg in range(hd.min_log2, hd.max_log2 + 1):
            s = 1 << lg
            nby, nbx = h // s, w // s
            n = nby * nbx
            mode[lg] = vec[off:off + n].reshape(nby, nbx).astype(np.int32)
            off += n
            split[lg] = vec[off:off + n].reshape(nby, nbx).astype(bool)
            off += n
        if hd.kind == "I":
            rc = None
            if off + 2 <= len(vec):
                rc = float((int(vec[off]) << 15) | int(vec[off + 1])) * 65536.0
            return AnalysisResult(mode=mode, split=split, leaf_cost=None,
                                  tree_cost=None, rc_cost=rc)
        nby16c, nbx16c = _ceil_div(h, 16), _ceil_div(w, 16)
        n16 = nby16c * nbx16c * 2

        def next_plane():
            nonlocal off
            m16 = vec[off:off + n16].reshape(nby16c, nbx16c,
                                             2).astype(np.int32)
            off += n16
            maps = {}
            for lg in range(hd.min_log2, hd.max_log2 + 1):
                s = 1 << lg
                maps[lg] = _mv_for_level_np(m16, lg, h // s, w // s)
            return maps

        def read_researched(maps):
            """Override the large-CU levels of the L0r0 maps with the
            device-re-searched per-CU MVs (packed right after its 16x16
            field)."""
            nonlocal off
            for lg in range(max(5, hd.min_log2), hd.max_log2 + 1):
                s = 1 << lg
                nby, nbx = h // s, w // s
                if nby == 0 or nbx == 0:
                    continue
                n = nby * nbx * 2
                maps[lg] = vec[off:off + n].reshape(nby, nbx,
                                                    2).astype(np.int32)
                off += n
            return maps

        has0, has0b, has1, has1b, hasbi = hd.planes
        mv = read_researched(next_plane()) if has0 else None
        mv0b = next_plane() if has0b else None
        mv1 = next_plane() if has1 else None
        mv1b = next_plane() if has1b else None
        mvbi = next_plane() if hasbi else None

        def rc_cost():
            if off + 2 > len(vec):     # older packed vecs (meshed twin)
                return None
            hi, lo = int(vec[off]), int(vec[off + 1])
            return float((hi << 15) | lo) * 65536.0

        if hd.kind == "B" and mv1 is None:
            mv1 = {lg: mv[lg] for lg in mv}
        return InterAnalysisResult(mode=mode, split=split, leaf_cost=None,
                                   tree_cost=None, mv=mv, mv1=mv1,
                                   mv0b=mv0b, mv1b=mv1b, mvbi=mvbi,
                                   rc_cost=rc_cost())
