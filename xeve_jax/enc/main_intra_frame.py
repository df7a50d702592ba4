"""Closed-loop Main-profile intra frame coding pass (numpy oracle).

Walks the CTU quadtrees in z-order coding the analysis decisions with the
Main toolset stage 1: EIPD 33-mode prediction, IQT quantization scales,
CM_INIT adaptive contexts, ADCC coefficient coding, DM chroma.  By
construction the emitted bitstream decodes to exactly the reconstruction
this pass keeps (same invariant as the Baseline passes).

Reference counterparts: xevem.c:40-196 (xevem_eco_tree, quad subset),
xevem_pintra.c (closed-loop residue), xevem_eco.c:1103/1541/1598 (syntax).
A C fast path mirrors this in xeve_jax/native; this module is the oracle.
"""
from __future__ import annotations

import numpy as np

from ..constants import MIN_CU_LOG2, MIN_CU_SIZE, SLICE_I, chroma_qp_dynamic
from ..entropy.sbac import SbacEncoder, SbacCtx
from ..ops import reference_kernels as rk
from ..ops import intra_main_np as im
from ..ops.deblock_np import deblock_frame
from . import syntax, syntax_main
from .rdoq import rdoq_block_adcc, bit_est_tables
from .analysis_np import AnalysisResult


def _coef_bins(lev, nnz):
    """Bin-count estimate, exact twin of native xt_coef_bins."""
    if not nnz:
        return 0
    a = np.abs(np.asarray(lev).reshape(-1))
    idx = np.nonzero(a)[0]
    return int(a.sum()) + 2 * len(idx) + int(idx[-1]) + 1


class MainIntraFramePass:
    def __init__(self, w, h, bd, bd_chroma_minus8, qp, qp_u_off, qp_v_off,
                 use_rdoq=True, use_deblock=True, tool_iqt=1, tool_htdf=0,
                 tool_ats=0, tool_addb=0):
        self.w, self.h, self.bd = w, h, bd
        self.bdc8 = bd_chroma_minus8
        self.qp = qp
        self.qp_u_off, self.qp_v_off = qp_u_off, qp_v_off
        self.iqt = tool_iqt
        self.htdf = tool_htdf
        self.ats = tool_ats
        self.addb = tool_addb
        self.qp_y = qp + 6 * (bd - 8)
        qpu_i = int(np.clip(qp + qp_u_off, -6 * bd_chroma_minus8, 57))
        qpv_i = int(np.clip(qp + qp_v_off, -6 * bd_chroma_minus8, 57))
        self.qp_u = chroma_qp_dynamic(qpu_i, tool_iqt) + 6 * bd_chroma_minus8
        self.qp_v = chroma_qp_dynamic(qpv_i, tool_iqt) + 6 * bd_chroma_minus8
        self.lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        self.lam_u = self.lam / (2.0 ** ((self.qp_y - self.qp_u) / 3.0))
        self.lam_v = self.lam / (2.0 ** ((self.qp_y - self.qp_v) / 3.0))
        self.use_rdoq = use_rdoq
        self.use_deblock = use_deblock
        self.w_scu = (w + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        self.h_scu = (h + MIN_CU_SIZE - 1) >> MIN_CU_LOG2
        self.w_lcu = (w + 63) >> 6
        self.h_lcu = (h + 63) >> 6

    def encode(self, orig_y, orig_u, orig_v, analysis: AnalysisResult,
               sbac: SbacEncoder, ctx: SbacCtx):
        w, h, bd = self.w, self.h, self.bd
        mid = 1 << (bd - 1)
        self.orig_y, self.orig_u, self.orig_v = orig_y, orig_u, orig_v
        self.rec_y = np.full((h, w), mid, dtype=np.int32)
        self.rec_u = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        self.rec_v = np.full((h >> 1, w >> 1), mid, dtype=np.int32)
        self.map_cod = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_if = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.map_ipm = np.full((self.h_scu, self.w_scu), -1, dtype=np.int32)
        self.map_qp = np.full((self.h_scu, self.w_scu), self.qp,
                              dtype=np.int32)
        self.map_cbf_l = np.zeros((self.h_scu, self.w_scu), dtype=bool)
        self.leaf_cus = []
        self.an = analysis
        self.sbac = sbac
        self.ctx = ctx

        for ly in range(self.h_lcu):
            for lx in range(self.w_lcu):
                self.est = bit_est_tables(ctx)
                self._code_tree(lx << 6, ly << 6, 6)
        sbac.encode_bin_trm(1)

        if self.use_deblock:
            if self.addb:
                from ..ops.addb_np import deblock_frame_addb
                deblock_frame_addb(self.rec_y, self.rec_u, self.rec_v,
                                   self.leaf_cus, self.map_if,
                                   self.map_cbf_l, self.map_qp,
                                   None, None, ([], []),
                                   self.qp_u_off, self.qp_v_off, bd,
                                   self.bdc8, main_qp_table=self.iqt)
            else:
                deblock_frame(self.rec_y, self.rec_u, self.rec_v,
                              self.leaf_cus, self.map_if, self.map_cbf_l,
                              self.map_qp, self.qp_u_off, self.qp_v_off,
                              bd, self.bdc8, main_qp_table=self.iqt)
        return self.rec_y, self.rec_u, self.rec_v, self.leaf_cus

    # ------------------------------------------------------------------
    def _code_tree(self, x, y, lg):
        s = 1 << lg
        boundary = (x + s > self.w) or (y + s > self.h)
        if boundary:
            split = True
        elif lg == 2:
            split = False
        else:
            by, bx = y >> lg, x >> lg
            split = (bool(self.an.split[lg][by, bx])
                     if lg in self.an.split else False)
        if s >= 8:
            syntax.write_split_flag(self.sbac, self.ctx, 1 if split else 0)
        if split:
            half = s >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                xp, yp = x + dx, y + dy
                if xp < self.w and yp < self.h:
                    self._code_tree(xp, yp, lg - 1)
        else:
            self._code_cu(x, y, lg)

    def _itdq(self, lev, qp_c):
        d = rk.dequant(lev, qp_c, self.bd, iqt=self.iqt)
        if self.iqt:
            return rk.inverse_dct2_iqt(d, self.bd)
        return rk.inverse_dct2(d, self.bd)

    def _avail_intra_flags(self, x_scu, y_scu, scuw, scuh):
        cod = self.map_cod
        w_scu, h_scu = self.w_scu, self.h_scu
        le = x_scu > 0 and cod[y_scu, x_scu - 1]
        ri = x_scu + scuw < w_scu and cod[y_scu, x_scu + scuw]
        diag = y_scu + scuh + scuw - 1 < h_scu
        return {
            "le": le,
            "ri": ri,
            "up": y_scu > 0,
            "up_le": x_scu > 0 and y_scu > 0 and cod[y_scu - 1, x_scu - 1],
            "up_ri": (y_scu > 0 and x_scu + scuw < w_scu and
                      cod[y_scu - 1, x_scu + scuw]),
            "lo_le": bool(le and diag and
                          cod[y_scu + scuw + scuh - 1, x_scu - 1]),
            "lo_ri": bool(ri and diag and
                          cod[y_scu + scuw + scuh - 1, x_scu + scuw]),
        }

    def _code_cu(self, x, y, lg):
        s = 1 << lg
        bd = self.bd
        x_scu, y_scu = x >> MIN_CU_LOG2, y >> MIN_CU_LOG2
        scuw = scuh = s >> MIN_CU_LOG2
        ipm = int(self.an.mode[lg][y >> lg, x >> lg])
        ipm_c = im.IPD_DM_C

        # --- luma closed loop (exact EIPD prediction from recon), with the
        # DCT-2 vs ATS DST7xDST7 2-candidate choice mirrored bit-exactly in
        # native/xt_core.c xt_code_cu_main ---
        nb = im.get_nbr_main(self.rec_y, x, y, s, s, x_scu, y_scu,
                             self.map_cod, self.w_scu, self.h_scu,
                             MIN_CU_SIZE, bd)
        pred_y = np.asarray(im.ipred_main(ipm, nb, s, s, bd), np.int32)
        resi = self.orig_y[y:y + s, x:x + s].astype(np.int32) - pred_y
        ats_ok = self.ats and lg <= 5
        orig_blk = self.orig_y[y:y + s, x:x + s].astype(np.int64)
        best = None
        nnz_dct2 = 0
        for cand in range(2 if ats_ok else 1):
            if cand == 1 and nnz_dct2 <= 1:
                break                # fast gate, identical to the C pass
            if cand == 0:
                coef_y = rk.forward_dct2(resi, bd)
            else:
                coef_y = rk.forward_ats(resi, 0, bd)
            if self.use_rdoq:
                lev_c, nnz = rdoq_block_adcc(coef_y, self.qp_y, self.lam,
                                             0, True, bd, self.est,
                                             tool_iqt=self.iqt)
            else:
                lev_c, nnz = rk.quant(coef_y, self.qp_y, SLICE_I, bd,
                                      tool_iqt=self.iqt)
            if cand == 0:
                nnz_dct2 = nnz
            if cand == 1 and not nnz:
                continue             # ATS needs cbf to signal
            if nnz:
                d = rk.dequant(lev_c, self.qp_y, bd, iqt=self.iqt)
                if cand == 1:
                    rr = rk.inverse_ats(d, 0, bd)
                elif self.iqt:
                    rr = rk.inverse_dct2_iqt(d, bd)
                else:
                    rr = rk.inverse_dct2(d, bd)
            else:
                rr = None
            rec_c = rk.recon_block(pred_y, rr, bd)
            ssd = int(((orig_blk - rec_c) ** 2).sum())
            bins = _coef_bins(lev_c, nnz) \
                + (3 if cand == 1 else (1 if (ats_ok and nnz) else 0))
            cost = float(ssd) + self.lam * float(bins)
            if best is None or cost < best[0]:
                best = (cost, cand, lev_c, nnz, rec_c)
        _, ats_cu, lev_y, nnz_y, rec_best = best
        self.rec_y[y:y + s, x:x + s] = rec_best

        # --- chroma closed loop (DM) ---
        xc, yc, sc = x >> 1, y >> 1, s >> 1
        out_c = []
        for (plane, orig, qp_c, lam_c, ch) in (
                (self.rec_u, self.orig_u, self.qp_u, self.lam_u, 1),
                (self.rec_v, self.orig_v, self.qp_v, self.lam_v, 2)):
            nbc = im.get_nbr_main(plane, xc, yc, sc, sc, x_scu, y_scu,
                                  self.map_cod, self.w_scu, self.h_scu,
                                  MIN_CU_SIZE >> 1, bd)
            pred = np.asarray(im.ipred_uv_main(ipm_c, ipm, nbc, sc, sc, bd),
                              np.int32)
            resi = orig[yc:yc + sc, xc:xc + sc].astype(np.int32) - pred
            coef = rk.forward_dct2(resi, bd)
            if self.use_rdoq:
                lev, nnz = rdoq_block_adcc(coef, qp_c, lam_c, ch,
                                           True, bd, self.est,
                                           tool_iqt=self.iqt)
            else:
                lev, nnz = rk.quant(coef, qp_c, SLICE_I, bd,
                                    tool_iqt=self.iqt)
            rr = self._itdq(lev, qp_c) if nnz else None
            plane[yc:yc + sc, xc:xc + sc] = rk.recon_block(pred, rr, bd)
            out_c.append((lev, nnz))
        (lev_u, nnz_u), (lev_v, nnz_v) = out_c

        # --- syntax ---
        mpm, ext, pims = im.get_mpm_main(x_scu, y_scu, scuw, self.map_cod,
                                         self.map_if, self.map_ipm,
                                         self.w_scu)
        syntax_main.write_intra_dir_main(self.sbac, self.ctx, ipm, mpm, ext,
                                         pims)
        syntax_main.write_intra_dir_c_main(self.sbac, self.ctx, ipm_c, ipm)
        syntax.write_cbf_intra(self.sbac, self.ctx,
                               1 if nnz_y else 0, 1 if nnz_u else 0,
                               1 if nnz_v else 0)
        if ats_ok and nnz_y:
            # ats_intra_cu (EP) + tuH/tuV mode bits (xevem_eco.c:1396)
            self.sbac.encode_bin_ep(ats_cu)
            if ats_cu:
                self.sbac.encode_bin(0, self.ctx.ats_mode, 0)
                self.sbac.encode_bin(0, self.ctx.ats_mode, 0)
        if nnz_y:
            syntax_main.write_coef_block_main(self.sbac, self.ctx, lev_y, 0)
        if nnz_u:
            syntax_main.write_coef_block_main(self.sbac, self.ctx, lev_u, 1)
        if nnz_v:
            syntax_main.write_coef_block_main(self.sbac, self.ctx, lev_v, 1)

        # --- HTDF on the luma recon (xevem_pintra.c:106) ---
        if self.htdf:
            from ..ops import htdf_np
            htdf_np.htdf_cu(self.rec_y, x, y, s, s, self.qp, True,
                            self._avail_intra_flags(x_scu, y_scu, scuw, scuh),
                            bd)

        # --- maps ---
        hs = ws = s >> MIN_CU_LOG2
        self.map_cod[y_scu:y_scu + hs, x_scu:x_scu + ws] = True
        self.map_if[y_scu:y_scu + hs, x_scu:x_scu + ws] = True
        self.map_ipm[y_scu:y_scu + hs, x_scu:x_scu + ws] = ipm
        self.map_cbf_l[y_scu:y_scu + hs, x_scu:x_scu + ws] = bool(nnz_y)
        self.leaf_cus.append((x, y, s, s))
