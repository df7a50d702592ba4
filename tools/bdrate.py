"""BD-rate harness: 4-QP ladders vs the reference encoder.

Methodology follows the reference app's PSNR accounting
(app/xeve_app.c:339-388): per-frame Y-PSNR against the 10-bit source,
averaged; rate = total bits / frames.  BD-rate via the standard
piecewise-cubic log-rate integration (Bjontegaard).

The xeve anchor streams are produced by .refbuild/bin/xeve_app and decoded
with OUR conformance decoder (bit-exact on xeve output), so both sides'
PSNR use identical arithmetic.

Usage: python tools/bdrate.py [--size cif|1080p] [--frames N]
Writes a JSON summary to stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

XEVE = os.path.join(ROOT, ".refbuild", "bin", "xeve_app")
QPS = (22, 27, 32, 37)


def bd_rate(r1, p1, r2, p2):
    """BD-rate of (r2,p2) vs anchor (r1,p1) in percent (negative = better).
    Piecewise-cubic integration over the overlapping PSNR interval."""
    lr1, lr2 = np.log(np.asarray(r1, float)), np.log(np.asarray(r2, float))
    p1, p2 = np.asarray(p1, float), np.asarray(p2, float)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    int1 = np.polyval(i1, hi) - np.polyval(i1, lo)
    int2 = np.polyval(i2, hi) - np.polyval(i2, lo)
    avg_diff = (int2 - int1) / (hi - lo)
    return float((np.exp(avg_diff) - 1.0) * 100.0)


def gen_clip(w, h, n):
    from tools.gen_test_content import gen_frame
    frames8 = []
    frames10 = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        frames8.append((y, u, v))
        frames10.append((y.astype(np.int32) << 2, u.astype(np.int32) << 2,
                        v.astype(np.int32) << 2))
    return frames8, frames10


def psnr_y(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(1023.0 ** 2 / mse)


def run_ours(frames10, w, h, qp, profile, keyint, bframes, analysis="numpy",
             **extra):
    from xeve_jax.api import Encoder, GopEncoder
    from xeve_jax.params import EncoderParams
    p = EncoderParams(w=w, h=h, qp=qp, keyint=keyint, bframes=bframes,
                      profile=profile, **extra)
    enc = (GopEncoder if bframes >= 15 else Encoder)(p, analysis=analysis,
                                                     coder="native")
    nbytes = 0
    ps = []
    for bs, rec, poc in enc.encode_stream(iter(frames10)):
        nbytes += len(bs)
        ps.append(psnr_y(frames10[poc][0], rec[0][:h, :w]))
    kbps = nbytes * 8 * 30.0 / len(ps) / 1000.0
    return kbps, float(np.mean(ps))


def run_xeve(yuv_path, frames10, w, h, qp, profile, keyint, bframes, n,
             xeve_extra=()):
    """PSNR/rate from xeve_app's own summary (-v 3), 10-bit PSNR vs input
    — works for the full Main toolset (ALF/BTT) without a decode."""
    with tempfile.NamedTemporaryFile(suffix=".evc", delete=False) as f:
        evc = f.name
    cmd = [XEVE, "-i", yuv_path, "-w", str(w), "-h", str(h), "-z", "30",
           "-q", str(qp), "-I", str(keyint), "-b", str(bframes),
           "--profile", "main" if profile else "baseline",
           "--preset", "medium", "-m", "1", "--frames", str(n), "-o", evc,
           "-v", "3"] + list(xeve_extra)
    txt = subprocess.run(cmd, capture_output=True, text=True).stdout
    os.unlink(evc)
    psnr = kbps = None
    for line in txt.splitlines():
        if "PSNR Y(dB)" in line:
            psnr = float(line.split(":")[1])
        elif line.strip().startswith("Bitrate"):
            kbps = float(line.split("=")[1].split("kbps")[0])
    assert psnr is not None and kbps is not None, txt[-500:]
    return kbps, psnr


def ladder(name, w, h, n, profile, keyint, bframes, frames8, frames10,
           analysis="numpy", ours_extra=None, xeve_extra=()):
    yuv = os.path.join(tempfile.gettempdir(), f"bd_{name}.yuv")
    with open(yuv, "wb") as f:
        for (y, u, v) in frames8:
            f.write(y.astype(np.uint8).tobytes())
            f.write(u.astype(np.uint8).tobytes())
            f.write(v.astype(np.uint8).tobytes())
    ours_r, ours_p, ref_r, ref_p = [], [], [], []
    for qp in QPS:
        r, p = run_ours(frames10, w, h, qp, profile, keyint, bframes,
                        analysis, **(ours_extra or {}))
        ours_r.append(r)
        ours_p.append(p)
        r, p = run_xeve(yuv, frames10, w, h, qp, profile, keyint, bframes, n,
                        xeve_extra)
        ref_r.append(r)
        ref_p.append(p)
    bd = bd_rate(ref_r, ref_p, ours_r, ours_p)
    return {"config": name, "bd_rate_pct_vs_xeve_medium": round(bd, 2),
            "ours": [[round(r, 1), round(p, 2)]
                     for r, p in zip(ours_r, ours_p)],
            "xeve": [[round(r, 1), round(p, 2)]
                     for r, p in zip(ref_r, ref_p)]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--w", type=int, default=352)
    ap.add_argument("--h", type=int, default=288)
    ap.add_argument("--configs", default="ai,ld,ra,ai_main,ra_main")
    ap.add_argument("--analysis", default="numpy")
    args = ap.parse_args()
    if not os.path.exists(XEVE):
        print(json.dumps({"error": "no .refbuild/bin/xeve_app"}))
        return
    w, h, n = args.w, args.h, args.frames
    frames8, frames10 = gen_clip(w, h, n)
    # (profile, keyint, bframes, ours_extra, xeve_extra): matched-settings
    # ladders; ld_ref2 compares 2 active refs on both sides
    cfgs = {
        "ai": (0, 1, 0, None, ()),
        "ld": (0, 0, 0, None, ()),
        "ra": (0, 0, 15, None, ()),
        "ld_ref2": (0, 0, 0, {"ref_pics": 2}, ("--ref", "2")),
        "ld_ref4": (0, 0, 0, {"ref_pics": 4}, ("--ref", "4")),
        "ra_ref4": (0, 0, 15, {"ref_pics": 4}, ("--ref", "4")),
        "ra_ref2": (0, 0, 15, {"ref_pics": 2}, ("--ref", "2")),
        "ra_aq": (0, 0, 15, {"aq_mode": 2}, ("--aq", "1")),
        "ai_main": (1, 1, 0, None, ()),
        "ai_main_btt": (1, 1, 0, {"btt": 1}, ()),
        "ra_main": (1, 0, 15, None, ()),
    }
    out = []
    for name in args.configs.split(","):
        profile, keyint, bframes, ours_extra, xeve_extra = cfgs[name]
        out.append(ladder(name, w, h, n, profile, keyint, bframes,
                          frames8, frames10, args.analysis,
                          ours_extra=ours_extra, xeve_extra=xeve_extra))
        print(json.dumps(out[-1]), flush=True)


if __name__ == "__main__":
    main()
