"""Open-loop intra analysis (numpy prototype of the device analysis stage).

Batched design (SURVEY.md §7.1): instead of the reference's depth-first
per-CU RDO recursion (xeve_mode.c:2007 mode_coding_tree), evaluate ALL
candidate blocks of every quadtree level as dense batched tensors —
prediction for all 5 modes, transform (matmul), deadzone quantization,
inverse, SSD distortion and a bin-count rate estimate — then pick the
partition with a bottom-up dynamic program.  Neighbour references come from
the *original* picture (open loop); the sequential closed-loop pass only
re-derives residuals for the chosen modes.

The JAX device implementation (analysis_jax.py) mirrors this module; this numpy
version is its golden reference and the CPU fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (TM, SCAN, QUANT_SCALE, DQUANT_SCALE_B,
                         MAX_TX_DYNAMIC_RANGE, QUANT_SHIFT,
                         QUANT_IQUANT_SHIFT, SLICE_I)


# Open-loop bias correction per quadtree level, calibrated against the
# closed-loop pass + reference anchors at QP 22-37 (tools/bdrate.py):
# open-loop leaf costs of small blocks are optimistic (original-pixel
# neighbours predict deceptively well), which made the partition DP
# over-split at low QP (xeve_mode.c evaluates splits with exact closed-
# loop RDO instead; this factor is our calibrated stand-in).
LEVEL_COST_CORRECTION = {2: 1.3, 3: 1.1}

# intra coefficient-rate estimate calibration (fit against the AI BD
# ladder; shared with the jax twin which bakes it at trace time)
BITS_SCALE = 1.0


def corrected_leaf(lg, cost):
    g = LEVEL_COST_CORRECTION.get(lg)
    return cost * g if g else cost


@dataclass
class AnalysisResult:
    # per level (log2 size): best mode map (nby, nbx) and whether to split
    mode: dict
    split: dict          # split[s][by][bx] True => split block of size 2^s
    leaf_cost: dict
    tree_cost: dict
    rc_cost: float = None   # frame complexity scalar for rate control


def _blocks(plane: np.ndarray, s: int) -> np.ndarray:
    h, w = plane.shape
    nby, nbx = h // s, w // s
    return plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s).transpose(0, 2, 1, 3)


def _neighbors(plane: np.ndarray, s: int, bd: int):
    """Open-loop up (nby, nbx, 2s), left (nby, nbx, 2s), upleft (nby, nbx)."""
    h, w = plane.shape
    nby, nbx = h // s, w // s
    mid = 1 << (bd - 1)
    pad = np.full((h + 1, w + 2 * s), mid, dtype=np.int32)
    pad[1:, s:s + w] = plane
    # up row for block (j,i): pad[j*s, s + i*s : s + i*s + 2s]
    up = np.stack([pad[j * s, :] for j in range(nby)])      # (nby, w+2s)
    up_blocks = np.stack([up[:, s + i * s: 3 * s + i * s] for i in range(nbx)], axis=1)
    # mask out up segments that extend beyond picture width (unavailable)
    # pad already mid beyond w; segments inside pic always "available" OL
    padl = np.full((h + 2 * s, w + 1), mid, dtype=np.int32)
    padl[s:s + h, 1:] = plane
    left = np.stack([padl[:, i * s] for i in range(nbx)], axis=0)  # (nbx, h+2s)
    left_blocks = np.stack([left[:, s + j * s: 3 * s + j * s] for j in range(nby)], axis=0)
    left_blocks = left_blocks.transpose(0, 1, 2)  # (nby, nbx, 2s)
    ul = np.full((nby, nbx), mid, dtype=np.int32)
    ul[1:, 1:] = plane[s - 1::s, s - 1::s][:nby - 1, :nbx - 1]
    # first row/col: unavailable -> mid (matches closed loop at frame edge)
    return up_blocks, left_blocks, ul


def _pred_all_modes(up, left, ul, s: int):
    """(nby, nbx, 5, s, s) predictions for DC/HOR/VER/UL/UR."""
    nby, nbx, _ = up.shape
    preds = np.empty((nby, nbx, 5, s, s), dtype=np.int32)
    # DC
    dc = (left[:, :, :s].sum(-1) + up[:, :, :s].sum(-1) + s) >> ((s.bit_length() - 1) + 1)
    preds[:, :, 0] = dc[:, :, None, None]
    # HOR
    preds[:, :, 1] = np.repeat(left[:, :, :s, None], s, axis=3)
    # VER
    preds[:, :, 2] = np.repeat(up[:, :, None, :s], s, axis=2)
    # UL (diagonal down-right)
    ii = np.arange(s)[:, None]
    jj = np.arange(s)[None, :]
    diag = ii - jj
    le_idx = np.clip(diag - 1, 0, 2 * s - 1)
    up_idx = np.clip(-diag - 1, 0, 2 * s - 1)
    lv = left[:, :, le_idx]
    uv = up[:, :, up_idx]
    preds[:, :, 3] = np.where(diag > 0, lv, np.where(diag == 0, ul[:, :, None, None], uv))
    # UR
    idx = ii + jj + 1
    preds[:, :, 4] = (up[:, :, idx] + left[:, :, idx]) >> 1
    return preds


def _fwd_tq_cost(orig_blocks, preds, qp, lam, bd, slice_type, weight=1.0,
                 tool_iqt=0):
    """Batched T/Q/IQ/IT cost: returns (dist, bits, nnz_flag) with shapes
    (nby, nbx, 5)."""
    nby, nbx, nm, s, _ = preds.shape
    resi = orig_blocks[:, :, None].astype(np.int64) - preds
    T = TM[s].astype(np.int64)
    log2s = s.bit_length() - 1
    shift_fwd = (log2s - 1 + bd - 8) + (log2s + 6)
    add_f = 1 << (shift_fwd - 1)
    coef = np.einsum('vk,yxmkl,ul->yxmvu', T, resi, T)
    coef = (coef + add_f) >> shift_fwd
    # deadzone quant
    scale = int(QUANT_SCALE[tool_iqt][qp % 6])
    tr_shift = MAX_TX_DYNAMIC_RANGE - bd - log2s
    shift_q = QUANT_SHIFT + tr_shift + qp // 6
    offset = (171 if slice_type == SLICE_I else 85) << (shift_q - 9)
    lev = (np.abs(coef) * scale + offset) >> shift_q
    lev = np.minimum(lev, 32767)
    lev = np.where(coef < 0, -lev, lev)
    # dequant + inverse
    dq_scale = int(DQUANT_SCALE_B[qp % 6]) << (qp // 6)
    shift_dq = QUANT_IQUANT_SHIFT - QUANT_SHIFT - tr_shift
    off_dq = 1 << (shift_dq - 1) if shift_dq > 0 else 0
    dq = (lev * dq_scale + off_dq) >> shift_dq
    dq = np.clip(dq, -32768, 32767)
    shift_inv = 7 + (12 - (bd - 8))
    add_i = 1 << (shift_inv - 1)
    r1 = np.einsum('vk,yxmvu->yxmku', T, dq)
    r1 = np.clip(r1, -(2 ** 31) + 1, 2 ** 31 - 1)
    resi_rec = (np.einsum('yxmku,un->yxmkn', r1, T) + add_i) >> shift_inv
    resi_rec = np.clip(resi_rec, -(1 << MAX_TX_DYNAMIC_RANGE), (1 << MAX_TX_DYNAMIC_RANGE) - 1)
    rec = np.clip(preds + resi_rec, 0, (1 << bd) - 1)
    dist = ((orig_blocks[:, :, None] - rec) ** 2).sum(axis=(-1, -2)).astype(np.float64)

    # rate estimate: run-length bin count (~1 bit/bin at init states)
    flat = np.abs(lev).reshape(nby, nbx, nm, s * s)
    scan = SCAN[(s, s)]
    scanned = flat[..., scan]
    nz = scanned > 0
    nsig = nz.sum(-1)
    pos = np.arange(s * s)
    last_idx = np.where(nsig > 0, (nz * pos).max(-1), -1)
    lev_bins = np.minimum(scanned, 32).sum(-1)  # unary level bins (capped est)
    bits = BITS_SCALE * ((last_idx + 1) + lev_bins + 2 * nsig) + 3
    bits = np.where(nsig == 0, 3, bits)
    return dist * weight, bits.astype(np.float64), nsig


def analyze_frame(orig_y, orig_u, orig_v, qp, qp_y, qp_u, qp_v, bd,
                  slice_type=SLICE_I, max_log2=6, min_log2=2):
    """Full open-loop analysis; qp is the slice QP (for lambda), qp_y/u/v the
    bit-depth-offset quantizer indices.  Returns AnalysisResult."""
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    w_u = 2.0 ** ((qp_y - qp_u) / 3.0)
    w_v = 2.0 ** ((qp_y - qp_v) / 3.0)
    h, w = orig_y.shape
    mode = {}
    leaf_cost = {}
    for lg in range(min_log2, max_log2 + 1):
        s = 1 << lg
        oy = _blocks(orig_y, s)
        upY, leY, ulY = _neighbors(orig_y, s, bd)
        pY = _pred_all_modes(upY, leY, ulY, s)
        dY, bY, _ = _fwd_tq_cost(oy, pY, qp_y, lam, bd, slice_type)
        sc = s >> 1
        ou = _blocks(orig_u, sc)
        ov = _blocks(orig_v, sc)
        upU, leU, ulU = _neighbors(orig_u, sc, bd)
        upV, leV, ulV = _neighbors(orig_v, sc, bd)
        pU = _pred_all_modes(upU, leU, ulU, sc)
        pV = _pred_all_modes(upV, leV, ulV, sc)
        dU, bU, _ = _fwd_tq_cost(ou, pU, qp_u, lam, bd, slice_type)
        dV, bV, _ = _fwd_tq_cost(ov, pV, qp_v, lam, bd, slice_type)
        nby, nbx = dY.shape[:2]
        dU = dU[:nby, :nbx]
        dV = dV[:nby, :nbx]
        bU = bU[:nby, :nbx]
        bV = bV[:nby, :nbx]
        cost = dY + w_u * dU + w_v * dV + lam * (bY + bU + bV + 3.0)
        mode[lg] = np.argmin(cost, axis=2)
        leaf_cost[lg] = np.min(cost, axis=2)

    # bottom-up DP: tree_cost[lg] = min(leaf, sum of 4 children) (+ split bits)
    tree_cost = {min_log2: corrected_leaf(min_log2, leaf_cost[min_log2])}
    split = {min_log2: np.zeros_like(leaf_cost[min_log2], dtype=bool)}
    for lg in range(min_log2 + 1, max_log2 + 1):
        s = 1 << lg
        nby, nbx = leaf_cost[lg].shape
        child = tree_cost[lg - 1]
        ch = child[:nby * 2, :nbx * 2]
        sum4 = (ch[0::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 0::2] + ch[1::2, 1::2])
        # leaf invalid if block crosses picture boundary
        ys = (np.arange(nby) + 1) * s
        xs = (np.arange(nbx) + 1) * s
        valid = (ys[:, None] <= h) & (xs[None, :] <= w)
        lam_split = lam * 1.0  # split flag ~1 bin
        leafc = np.where(valid, corrected_leaf(lg, leaf_cost[lg]), np.inf)
        split[lg] = sum4 + lam_split < leafc
        tree_cost[lg] = np.where(split[lg], sum4 + lam_split, leafc)
    return AnalysisResult(mode=mode, split=split, leaf_cost=leaf_cost,
                          tree_cost=tree_cost)
