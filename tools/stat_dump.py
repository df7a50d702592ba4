#!/usr/bin/env python
"""Per-CU statistics dump (xevem_stat.c GRAB_STAT analog).

Decodes a stream and emits one JSON line per frame with per-CU records:
position/size, prediction mode, intra direction, refi/MV pairs, qp, cbf —
the same observability surface the reference's compile-time GRAB_STAT
logger provides (xevem_stat.h:44-66), but always available and driven
from the conformance decoder's maps.

Usage: python tools/stat_dump.py stream.evc [-o stats.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from xeve_jax.dec.decoder import BaselineIntraDecoder


def dump(stream_path, out_fp):
    dec = BaselineIntraDecoder()
    bs = open(stream_path, "rb").read()
    frames = dec.decode(bs)
    # re-decode frame by frame to capture per-frame maps
    dec2 = BaselineIntraDecoder()
    from xeve_jax.hls import split_nals
    from xeve_jax.constants import NUT_IDR, NUT_NONIDR, NUT_SPS, NUT_PPS
    fi = 0
    for hdr, payload, _full in split_nals(bs):
        nut = hdr.nal_unit_type
        if nut == NUT_SPS:
            from xeve_jax.hls import SPS
            from xeve_jax.io.bits import BitReader
            dec2.sps = SPS.parse(BitReader(payload))
            dec2._setup_dims()
            continue
        if nut == NUT_PPS:
            from xeve_jax.hls import PPS
            from xeve_jax.io.bits import BitReader
            dec2.pps = PPS.parse(BitReader(payload),
                                 main=dec2.sps.profile_idc == 1)
            continue
        if nut not in (NUT_IDR, NUT_NONIDR):
            continue
        dec2._decode_slice(payload, nut, hdr.nuh_temporal_id)
        cus = []
        for (x, y, w, h) in dec2.leaf_cus:
            ys, xs = y >> 2, x >> 2
            rec = {
                "x": x, "y": y, "w": w, "h": h,
                "intra": bool(dec2.map_if[ys, xs]),
                "qp": int(dec2.map_qp[ys, xs]),
                "cbf": bool(dec2.map_cbf_l[ys, xs]),
            }
            if rec["intra"]:
                rec["ipm"] = int(dec2.map_ipm[ys, xs])
            else:
                rec["skip"] = bool(dec2.map_skip[ys, xs])
                for lidx in (0, 1):
                    r = int(dec2.map_refi[ys, xs, lidx])
                    if r >= 0:
                        rec[f"l{lidx}"] = [r,
                                           int(dec2.map_mv[ys, xs, lidx, 0]),
                                           int(dec2.map_mv[ys, xs, lidx, 1])]
            cus.append(rec)
        out_fp.write(json.dumps({
            "frame": fi, "poc": dec2.poc,
            "slice_type": ["B", "P", "I"][dec2.sh.slice_type],
            "qp": dec2.sh.qp, "n_cu": len(cus), "cus": cus,
        }) + "\n")
        fi += 1
    return fi


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stream")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()
    out = open(args.output, "w") if args.output else sys.stdout
    n = dump(args.stream, out)
    if args.output:
        out.close()
        print(f"dumped {n} frames -> {args.output}")


if __name__ == "__main__":
    main()
