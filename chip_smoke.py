#!/usr/bin/env python
"""Smoke test of the encoder's main path on a GPU.

Run from the repository root on a GPU host:

    python chip_smoke.py             # every phase, on one GPU
    python chip_smoke.py --chips 4   # only the meshed RA path on 4 GPUs,
                                     # against the same encode on one

One process drives the card; CPU-only reference work (the numpy analysis
twins and the Python conformance decoder) runs in spawned worker processes
that never import JAX.  Phases, in order:

  device    JAX's first device must be a GPU, or the script exits non-zero.
            Prints it, nvidia-smi's name and power limit, the CPU count
            (which caps the C frame workers), the JAX version and the
            compile-cache directory.
  kernels   Decision agreement of the device analyzers at 1920x1088, QP 32:
            the fused analyzer's I frame against the exact-integer numpy
            twin; its P and B frames, and the `jax` inter engine, against
            the same jitted graphs on JAX's CPU backend; the Main EIPD
            analyzer against its numpy twin on a full-width strip.
  encodes   Five deployments through the public API (one through
            xeve_jax_app.py with --analysis auto): set-up, fps, kbps,
            PSNR-Y, peak device memory, compiles inside the timed pass
            (must be 0), recovered device failures (must be 0), and a
            bit-exact decode of the stream against the encoder's recon.
  trace     A jax.profiler trace of the 1080p RA encode: the ten device
            operations that take the most time and the device idle share.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase ends the run with a non-zero exit code and no such line.
"""
import argparse
import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
QP = 32
W, H = 1920, 1088          # full width of every 1080p deployment
MAIN_STRIP_H = 128         # Main numpy twin runs on a full-width strip
BOUND_I_VS_TWIN = 0.90     # tests/test_jax_analysis.py bound (f32 vs int)
BOUND_MAIN_VS_TWIN = 0.97  # tests/test_main_intra.py bound
BOUND_GPU_VS_CPU = 0.99    # same graph, two backends: numerics only


class SmokeFailure(RuntimeError):
    """A phase did not meet its bound."""


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# content and small helpers (no JAX: worker processes import this module)
# ---------------------------------------------------------------------------

_CONTENT = {}


def content(w, h, n):
    """n frames of tools/gen_test_content.py content as 10-bit int16
    (y, u, v), generated once per size and shared by the phases."""
    from tools.gen_test_content import gen_frame
    got = _CONTENT.setdefault((w, h), [])
    while len(got) < n:
        y, u, v = gen_frame(w, h, len(got))
        got.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return got[:n]


def planes_hash(*planes):
    h = hashlib.sha256()
    for p in planes:
        a = np.ascontiguousarray(p, dtype=np.int32)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def decode_hashes(stream):
    """{poc: hash of the decoded planes} for a bitstream (worker side)."""
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    return {f.poc: planes_hash(f.y, f.u, f.v)
            for f in BaselineIntraDecoder().decode(stream)}


def qp_triplet(qp, tool_iqt):
    from xeve_jax.constants import chroma_qp_dynamic
    qp_c = chroma_qp_dynamic(qp, tool_iqt) + 12
    return qp + 12, qp_c, qp_c


def twin_intra(w, h, qp):
    """Exact-integer Baseline intra analysis of frame 0 (worker side)."""
    from xeve_jax.enc.analysis_np import analyze_frame
    y, u, v = [np.asarray(p, np.int32) for p in content(w, h, 1)[0]]
    a = analyze_frame(y, u, v, qp, *qp_triplet(qp, 0), 10)
    return a.mode, a.split


def twin_main(w, h, qp):
    """Exact-integer Main EIPD analysis of frame 0 (worker side)."""
    from xeve_jax.enc.analysis_main_np import analyze_frame_main
    y, u, v = [np.asarray(p, np.int32) for p in content(w, h, 1)[0]]
    a = analyze_frame_main(y, u, v, qp, *qp_triplet(qp, 1), 10)
    return a.mode, a.split


class Inline:
    """Runs submitted work at once; stands in for a process pool."""

    def submit(self, fn, *args):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(fn(*args))
        return fut


def agreement(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise SmokeFailure(f"shape mismatch {a.shape} vs {b.shape}")
    return 1.0 if a.size == 0 else float((a == b).mean())


def check_levels(name, pairs, bound):
    """pairs: {label: (a, b)}; every label must agree at >= bound."""
    worst = 1.0
    for label, (a, b) in pairs.items():
        v = agreement(a, b)
        worst = min(worst, v)
        log(f"  {name} {label}: agreement {v:.4f} (bound >= {bound})")
        if v < bound:
            raise SmokeFailure(f"{name} {label}: agreement {v:.4f} < {bound}")
    return worst


def twin_pairs(a, mode, split):
    """{label: (device map, twin map)} for every level of a twin's
    (mode, split) maps."""
    pairs = {f"mode lg{lg}": (a.mode[lg], mode[lg]) for lg in sorted(mode)}
    pairs.update({f"split lg{lg}": (a.split[lg], split[lg])
                  for lg in sorted(split)})
    return pairs


def decision_pairs(a, b, mv_fields=()):
    pairs = {}
    for lg in sorted(a.mode):
        pairs[f"mode lg{lg}"] = (a.mode[lg], b.mode[lg])
        pairs[f"split lg{lg}"] = (a.split[lg], b.split[lg])
    for f in mv_fields:
        pairs[f"{f}[16x16]"] = (getattr(a, f)[4], getattr(b, f)[4])
    return pairs


# ---------------------------------------------------------------------------
# compile counting and device memory
# ---------------------------------------------------------------------------


class CompileCounter:
    """Times of every jit lowering (a compile request, whether the
    persistent cache then serves it or not)."""
    EVENT = "/jax/core/compile/jaxpr_to_mlir_module_duration"
    _times = None

    @classmethod
    def install(cls):
        if cls._times is None:
            import jax
            cls._times = []
            jax.monitoring.register_event_duration_secs_listener(
                lambda event, _secs, **_kw: cls._times.append(
                    time.perf_counter()) if event == cls.EVENT else None)

    @classmethod
    def count(cls, t0, t1):
        return sum(1 for t in cls._times if t0 <= t <= t1)


def peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def fmt_bytes(n):
    return "not reported" if n is None else f"{n / 2**30:.2f} GiB"


# ---------------------------------------------------------------------------
# phase: kernel agreement
# ---------------------------------------------------------------------------


def fused_decisions(device, cur, ref0, ref1, qp=QP):
    """Run the fused analyzer graph on `device` and parse its packed
    decision vector the way DeviceAnalyzer.collect does."""
    import jax
    from xeve_jax.enc.device_analyzer import (DeviceAnalyzer, _Handle,
                                              _fused_jit, fused_params, PAD)
    h, w = cur[0].shape
    put = lambda t: None if t is None else tuple(  # noqa: E731
        jax.device_put(np.asarray(p), device) for p in t)
    prms, prm3 = fused_params(qp, *qp_triplet(qp, 0), 10, 2, 6)
    refine = ref1 is not None
    vec = _fused_jit(*put(cur), put(ref0), None, put(ref1), None,
                     jax.device_put(prms, device),
                     jax.device_put(prm3, device), bd=10, R=16, pad=PAD,
                     min_log2=2, max_log2=6, refine=refine)
    kind = "I" if ref0 is None else ("B" if refine else "P")
    hd = _Handle(None, kind, h, w, 2, 6,
                 planes=(ref0 is not None, False, refine, False, refine))
    return DeviceAnalyzer(w, h)._parse(hd, np.asarray(vec))


def inter_jax_decisions(device, cur, ref0, ref1, qp=QP):
    """The `jax` engine's P/B analysis with every array on `device`."""
    import jax
    from xeve_jax.enc.analysis_inter_jax import analyze_frame_inter_jax, PAD
    from xeve_jax.ops import mc_np

    def ref(t, poc):
        y, u, v = [np.asarray(p, np.int32) for p in t]
        return {"poc": poc, "y_pad": mc_np.pad_picture(y, PAD),
                "u_pad": mc_np.pad_picture(u, PAD // 2),
                "v_pad": mc_np.pad_picture(v, PAD // 2)}
    y, u, v = [np.asarray(p, np.int32) for p in cur]
    with jax.default_device(device):
        return analyze_frame_inter_jax(y, u, v, [ref(ref0, 0)], qp,
                                       *qp_triplet(qp, 0), 10,
                                       refp1=[ref(ref1, 2)])


def check_kernels(w=W, h=H, strip_h=MAIN_STRIP_H, pool=None):
    """Agreement of every device analyzer at (w, h); returns the worst
    figure per check.  pool runs the numpy twins (None: in-process)."""
    import jax
    from xeve_jax.enc.analysis_jax import MATMUL_PRECISION
    from xeve_jax.enc.analysis_main_jax import analyze_frame_main_jax
    pool = pool or Inline()
    fut_i = pool.submit(twin_intra, w, h, QP)
    fut_m = pool.submit(twin_main, w, strip_h, QP)
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    f0, f1, f2 = content(w, h, 3)
    log(f"kernels: {w}x{h} QP {QP}; analysis matmuls at precision "
        f"{MATMUL_PRECISION.name}; device {gpu.platform}, reference "
        f"backend {cpu.platform}")
    out = {}

    t = time.perf_counter()
    a_dev = fused_decisions(gpu, f0, None, None)
    mode_np, split_np = fut_i.result()
    log(f"fused I frame vs exact-integer numpy twin "
        f"({time.perf_counter() - t:.1f} s):")
    out["fused_I_vs_numpy"] = check_levels(
        "fused I", twin_pairs(a_dev, mode_np, split_np), BOUND_I_VS_TWIN)

    for kind, ref1 in (("P", None), ("B", f2)):
        t = time.perf_counter()
        a_dev = fused_decisions(gpu, f1, f0, ref1)
        a_cpu = fused_decisions(cpu, f1, f0, ref1)
        fields = ("mv",) if kind == "P" else ("mv", "mv1", "mvbi")
        log(f"fused {kind} frame, {gpu.platform} vs {cpu.platform} backend "
            f"({time.perf_counter() - t:.1f} s):")
        out[f"fused_{kind}_dev_vs_cpu"] = check_levels(
            f"fused {kind}", decision_pairs(a_dev, a_cpu, fields),
            BOUND_GPU_VS_CPU)

    t = time.perf_counter()
    strip = [np.asarray(p, np.int32) for p in content(w, strip_h, 1)[0]]
    a_dev = analyze_frame_main_jax(*strip, QP, *qp_triplet(QP, 1), 10)
    mode_np, split_np = fut_m.result()
    log(f"Main EIPD analyzer on a {w}x{strip_h} strip vs numpy twin "
        f"({time.perf_counter() - t:.1f} s):")
    out["main_vs_numpy"] = check_levels(
        "main", twin_pairs(a_dev, mode_np, split_np), BOUND_MAIN_VS_TWIN)

    t = time.perf_counter()
    a_dev = inter_jax_decisions(gpu, f1, f0, f2)
    a_cpu = inter_jax_decisions(cpu, f1, f0, f2)
    log(f"jax inter engine (B), {gpu.platform} vs {cpu.platform} backend "
        f"({time.perf_counter() - t:.1f} s):")
    out["inter_jax_dev_vs_cpu"] = check_levels(
        "inter jax", decision_pairs(a_dev, a_cpu, ("mv", "mv1")),
        BOUND_GPU_VS_CPU)
    return out


# ---------------------------------------------------------------------------
# phase: end-to-end encodes
# ---------------------------------------------------------------------------

# (name, width, height, frames, keyint, bframes, profile, engine)
DEPLOYMENTS = (
    ("1080p Baseline RA GOP16", W, H, 17, 0, 15, 0, "device"),
    ("1080p Baseline AI (app)", W, H, 4, 1, 0, 0, "auto"),
    ("720p Baseline LD-P", 1280, 720, 8, 0, 0, 0, "device"),
    ("1080p Main AI", W, H, 2, 1, 0, 1, "jax"),
    ("1080p Main RA GOP16", W, H, 17, 0, 15, 1, "jax"),
)


def psnr_y(orig, rec):
    d = np.asarray(orig, np.float64) - np.asarray(rec, np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else 10.0 * np.log10(1023.0 ** 2 / mse)


def make_encoder(w, h, keyint, bframes, profile, engine, qp=QP):
    from xeve_jax.api import Encoder, GopEncoder
    from xeve_jax.params import EncoderParams
    p = EncoderParams(w=w, h=h, qp=qp, keyint=keyint, bframes=bframes,
                      profile=profile)
    return (GopEncoder if bframes >= 15 else Encoder)(
        p, analysis=engine, coder="native")


def encode_api(w, h, n, keyint, bframes, profile, engine):
    """Set-up pass (prewarm + 2 frames), then a timed pass on a new
    encoder.  Returns (result dict, [(AU bytes, poc, recon hash)] in
    coding order)."""
    fr = content(w, h, n)
    t0 = time.perf_counter()
    enc = make_encoder(w, h, keyint, bframes, profile, engine)
    enc.prewarm()
    for _ in enc.encode_stream(iter(fr[:2])):
        pass
    setup = time.perf_counter() - t0
    enc = make_encoder(w, h, keyint, bframes, profile, engine)
    t0 = time.perf_counter()
    outs = list(enc.encode_stream(iter(fr)))
    t1 = time.perf_counter()
    nbytes = sum(len(bs) for bs, _, _ in outs)
    dev = getattr(enc, "_dev", None)
    res = {"setup_s": setup, "fps": len(outs) / (t1 - t0),
           "kbps": nbytes * 8 * 30.0 / len(outs) / 1000.0,
           "psnr_y": float(np.mean([psnr_y(fr[poc][0], rec[0][:h, :w])
                                    for _, rec, poc in outs])),
           "compiles": CompileCounter.count(t0, t1),
           "failures": dev.failures if dev is not None else 0,
           "frames": len(outs)}
    aus = [(bs, poc, planes_hash(*rec)) for bs, rec, poc in outs]
    return res, aus


def encode_app(w, h, n, workdir):
    """The same deployment through xeve_jax_app.py in-process with
    --analysis auto; the app's recon dump is read back for the decode
    check."""
    import xeve_jax_app
    from tools.gen_test_content import gen_frame
    os.makedirs(workdir, exist_ok=True)
    src = os.path.join(workdir, "in.yuv")
    out = os.path.join(workdir, "out.evc")
    recf = os.path.join(workdir, "rec.yuv")
    with open(src, "wb") as f:
        for t in range(n):
            for p in gen_frame(w, h, t):
                f.write(p.tobytes())
    s = xeve_jax_app.main(["-i", src, "-w", str(w), "-h2", str(h),
                           "-q", str(QP), "-I", "1", "--frames", str(n),
                           "-o", out, "-r", recf, "--analysis", "auto",
                           "-v", "1"])
    if s["engine"] != "device":
        raise SmokeFailure(f"--analysis auto chose {s['engine']}, "
                           f"not device")
    with open(out, "rb") as f:
        stream = f.read()
    raw = np.fromfile(recf, dtype="<u2")
    fsz = w * h * 3 // 2
    aus = []
    from xeve_jax.hls import split_nals
    from xeve_jax.constants import NUT_IDR, NUT_NONIDR
    # all-intra: one slice NAL ends each AU, coding order == display
    # order; NALs are 4-byte length prefixed
    start = end = k = 0
    for hdr, _payload, full in split_nals(stream):
        end += 4 + len(full)
        if hdr.nal_unit_type in (NUT_IDR, NUT_NONIDR):
            fr = raw[k * fsz:(k + 1) * fsz]
            rec = (fr[:w * h].reshape(h, w),
                   fr[w * h:w * h + fsz // 6].reshape(h // 2, w // 2),
                   fr[w * h + fsz // 6:].reshape(h // 2, w // 2))
            aus.append((stream[start:end], k, planes_hash(*rec)))
            start, k = end, k + 1
    res = {"setup_s": s["setup_s"], "fps": s["fps"], "kbps": s["kbps"],
           "psnr_y": s["psnr_y"],
           "compiles": CompileCounter.count(*s["encode_window"]),
           "failures": s["analysis_failures"], "frames": s["frames"],
           "engine": s["engine"], "device": s["device"]}
    return res, aus


def run_encodes(deployments=DEPLOYMENTS, pool=None, workdir=None):
    """Every deployment; returns [(name, result)].  Decodes are submitted
    to `pool` as each encode ends and checked at the end."""
    pool = pool or Inline()
    workdir = workdir or os.path.join(OUT_DIR, "smoke")
    results, pending = [], []
    for name, w, h, n, keyint, bframes, profile, engine in deployments:
        if engine == "auto":
            res, aus = encode_app(w, h, n, workdir)
        else:
            res, aus = encode_api(w, h, n, keyint, bframes, profile, engine)
        res["peak_device_bytes"] = peak_bytes()
        # the whole Baseline RA stream; elsewhere the first 3 AUs
        n_dec = len(aus) if (bframes >= 15 and profile == 0) \
            else min(3, len(aus))
        res["decoded_aus"] = n_dec
        log(f"encode {name}: {n} frames, engine {res.get('engine', engine)}"
            f": set-up {res['setup_s']:.2f} s, {res['fps']:.3f} fps, "
            f"{res['kbps']:.1f} kbps, PSNR-Y {res['psnr_y']:.3f} dB, "
            f"peak device memory {fmt_bytes(res['peak_device_bytes'])} "
            f"(process peak so far), compiles in timed pass "
            f"{res['compiles']}, device failures {res['failures']}")
        if res["frames"] != n:
            raise SmokeFailure(f"{name}: {res['frames']} of {n} frames out")
        if res["compiles"]:
            raise SmokeFailure(f"{name}: {res['compiles']} compiles in the "
                               f"timed pass")
        if res["failures"]:
            raise SmokeFailure(f"{name}: {res['failures']} device analysis "
                               f"failures were recovered")
        stream = b"".join(bs for bs, _, _ in aus[:n_dec])
        want = {poc: hh for _, poc, hh in aus[:n_dec]}
        pending.append((name, pool.submit(decode_hashes, stream), want))
        results.append((name, res))
    for name, fut, want in pending:
        got = fut.result()
        bad = sorted(p for p in want if got.get(p) != want[p])
        if len(got) != len(want) or bad:
            raise SmokeFailure(f"{name}: decode differs from the encoder "
                               f"recon (pocs {bad}, {len(got)} decoded)")
        log(f"decode {name}: first {len(want)} access units in decode "
            f"order bit-exact with the encoder recon")
    return results


# ---------------------------------------------------------------------------
# phase: profiler trace
# ---------------------------------------------------------------------------

def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize_device_events(events, window=None, top=10):
    """events: [(name, start_ns, duration_ns)] of one device.  Returns the
    busy time, the idle share of the window (default: first event start to
    last event end) and the `top` names by total duration."""
    if not events:
        return {"events": 0}
    iv = [(s, s + d) for _, s, d in events]
    lo = min(s for s, _ in iv)
    hi = max(e for _, e in iv)
    if window is None or window[0] > lo or window[1] < hi:
        window, src = (lo, hi), "device span"
    else:
        src = "traced encode"
    busy = union_ns(iv)
    span = max(window[1] - window[0], 1.0)
    tot = {}
    for name, _, d in events:
        c, t = tot.get(name, (0, 0.0))
        tot[name] = (c + 1, t + d)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1][1])[:top]
    return {"events": len(events), "window_ns": span, "window_from": src,
            "busy_ns": busy, "idle_share": 1.0 - busy / span,
            "top": [{"name": k, "count": c, "total_ns": t}
                    for k, (c, t) in ranked]}


def read_trace(path):
    """(device events by plane, line names by plane, host window) from a
    .xplane.pb file.  A GPU plane's lines are its CUDA streams (kernels
    and copies), named by XLA's kernel names."""
    from jax.profiler import ProfileData
    window, planes, lines = None, {}, {}
    for plane in ProfileData.from_file(path).planes:
        is_dev = plane.name.startswith("/device:")
        if is_dev:
            lines[plane.name] = [ln.name for ln in plane.lines]
        for line in plane.lines:
            for ev in line.events:
                if is_dev:
                    planes.setdefault(plane.name, []).append(
                        (ev.name, ev.start_ns, ev.duration_ns))
                elif ev.name == "smoke_window":
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    return planes, lines, window


def run_trace(w=W, h=H, n=17, trace_dir=None):
    """Trace the 1080p Baseline RA encode (already compiled)."""
    import glob
    import jax
    trace_dir = trace_dir or os.path.join(OUT_DIR, "smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    fr = content(w, h, n)
    enc = make_encoder(w, h, 0, 15, 0, "device")
    jax.profiler.start_trace(trace_dir)
    try:
        with jax.profiler.TraceAnnotation("smoke_window"):
            for _ in enc.encode_stream(iter(fr)):
                pass
    finally:
        jax.profiler.stop_trace()
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SmokeFailure("the profiler wrote no trace")
    planes, lines, window = read_trace(paths[0])
    summary = {"frames": n, "lines": lines,
               "devices": {k: summarize_device_events(v, window)
                           for k, v in planes.items()}}
    shutil.rmtree(trace_dir, ignore_errors=True)
    return summary


def print_trace(summary):
    for plane, names in summary["lines"].items():
        log(f"trace {plane}: lines {names}")
    for plane, s in summary["devices"].items():
        if not s["events"]:
            continue
        log(f"trace {plane}: {s['events']} events over "
            f"{s['window_ns'] / 1e6:.1f} ms ({s['window_from']}); busy "
            f"{s['busy_ns'] / 1e6:.1f} ms; idle share {s['idle_share']:.3f}")
        for i, op in enumerate(s["top"], 1):
            log(f"  {i:2d}. {op['total_ns'] / 1e6:9.2f} ms  "
                f"x{op['count']:<6d} {op['name'][:90]}")


# ---------------------------------------------------------------------------
# --chips N: the meshed RA path against one card
# ---------------------------------------------------------------------------


def run_meshed(n_dev, w=W, h=H, n=17):
    import jax
    from xeve_jax.parallel.mesh import make_mesh
    devs = jax.devices()
    if len(devs) < n_dev:
        raise SmokeFailure(f"--chips {n_dev}: JAX sees {len(devs)} devices")
    mesh = make_mesh(n_dev)
    fr = content(w, h, n)

    def encode(meshed):
        enc = make_encoder(w, h, 0, 15, 0, "device")
        it = iter(fr)
        gen = enc.encode_stream_meshed(it, mesh) if meshed \
            else enc.encode_stream(it)
        t0 = time.perf_counter()
        out = b"".join(bs for bs, _, _ in gen)
        t1 = time.perf_counter()
        return out, n / (t1 - t0), CompileCounter.count(t0, t1)

    t0 = time.perf_counter()
    enc = make_encoder(w, h, 0, 15, 0, "device")
    enc.prewarm()
    encode(False)
    encode(True)
    log(f"mesh: set-up (compile + one pass each) "
        f"{time.perf_counter() - t0:.2f} s")
    one, fps_one, c_one = encode(False)
    many, fps_many, c_many = encode(True)
    log(f"mesh: {w}x{h} RA GOP16, {n} frames: one device {fps_one:.3f} fps "
        f"({c_one} compiles), {n_dev}-device mesh {fps_many:.3f} fps "
        f"({c_many} compiles); streams {len(one)} and {len(many)} bytes")
    if one != many:
        raise SmokeFailure("meshed bitstream differs from the one-device "
                           "bitstream")
    log("mesh: bitstreams byte-identical")
    peaks = [peak_bytes(d) for d in devs[:n_dev]]
    log("mesh: peak device memory " + ", ".join(
        f"{d.id}: {fmt_bytes(p)}" for d, p in zip(devs, peaks)))
    if devs[0].platform == "gpu" and not all(p for p in peaks):
        raise SmokeFailure("a mesh device reports no memory in use")
    return {"fps_one": fps_one, "fps_mesh": fps_many, "peaks": peaks}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def final_line(info):
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=0,
                    help="run only the meshed RA path on this many devices "
                         "and the one-device encode it is compared with")
    args = ap.parse_args(argv)
    try:
        from xeve_jax import compile_cache
        from xeve_jax.device import require_gpu, NoGpuError
    except ImportError as e:
        print(f"chip_smoke: the encoder package is missing: {e}",
              file=sys.stderr)
        return 1
    import jax
    cache = compile_cache.configure()
    try:
        info = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log(f"device: {info['platform']} {info['kind']} x{info['count']}")
    log(f"nvidia-smi: {info['nvidia_smi']}")
    log(f"host CPUs: {os.cpu_count()} (C frame workers: "
        f"min(4, CPU count))")
    log(f"jax {jax.__version__}; compile cache {cache}")
    CompileCounter.install()
    if args.chips:
        run_meshed(args.chips)
    else:
        import concurrent.futures
        import multiprocessing
        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=max(1, min(6, (os.cpu_count() or 2) - 4)),
            mp_context=multiprocessing.get_context("spawn"))
        try:
            agree = check_kernels(pool=pool)
            results = run_encodes(pool=pool)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        summary = run_trace()
        print_trace(summary)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump({"device": info, "agreement": agree,
                       "encodes": dict(results), "trace": summary}, f,
                      indent=1)
    log(f"nvidia-smi: {info['nvidia_smi']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(final_line(info), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
