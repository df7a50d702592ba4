"""Build + load the native library (gcc -O3 shared object via ctypes).

The library is built from the committed xt_core.c and tables.h into
build/ next to them (ignored by git), under a name keyed by a hash of both
sources, the compiler flags and the host CPU's feature flags.  A library
built on another machine or from other sources therefore never loads: a
host whose CPU differs builds its own.  tables.h is generated by
gen_tables.py and committed; the build never rewrites it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "build")
_SRC = os.path.join(_DIR, "xt_core.c")
_TABLES = os.path.join(_DIR, "tables.h")
CFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fvisibility=hidden")
LIBS = ("-lm", "-lpthread")

_lib = None


class XtFrameCfg(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int32), ("h", ctypes.c_int32),
                ("bd", ctypes.c_int32), ("qp", ctypes.c_int32),
                ("qp_u_off", ctypes.c_int32), ("qp_v_off", ctypes.c_int32),
                ("use_rdoq", ctypes.c_int32), ("use_deblock", ctypes.c_int32),
                ("main_eipd", ctypes.c_int32), ("tool_iqt", ctypes.c_int32),
                ("cm_init", ctypes.c_int32),
                ("tile_cols", ctypes.c_int32), ("tile_rows", ctypes.c_int32),
                ("threads", ctypes.c_int32),
                ("cu_qp_delta", ctypes.c_int32),
                ("cu_qp_delta_area", ctypes.c_int32),
                ("dquant_flag", ctypes.c_int32),
                ("tool_ats", ctypes.c_int32),
                ("tool_htdf", ctypes.c_int32),
                ("tool_addb", ctypes.c_int32),
                ("addb_alpha_off", ctypes.c_int32),
                ("addb_beta_off", ctypes.c_int32),
                ("sps_btt", ctypes.c_int32),
                ("exact_rd", ctypes.c_int32)]


class XtStats(ctypes.Structure):
    _fields_ = [("payload_bytes", ctypes.c_int64),
                ("bin_count", ctypes.c_int64),
                ("n_leaf", ctypes.c_int32),
                ("n_tiles", ctypes.c_int32),
                ("tile_len", ctypes.c_int32 * 64)]


class XtRefPic(ctypes.Structure):
    """Reference picture (padded planes + motion map) for the inter pass."""
    _fields_ = [("y", ctypes.POINTER(ctypes.c_uint16)),
                ("u", ctypes.POINTER(ctypes.c_uint16)),
                ("v", ctypes.POINTER(ctypes.c_uint16)),
                ("map_mv", ctypes.POINTER(ctypes.c_int32)),
                ("poc", ctypes.c_int32),
                ("list0_poc", ctypes.c_int32)]


def host_cpu_flags() -> str:
    """The CPU feature flags -march=native compiles for (x86 `flags` or
    Arm `Features` of /proc/cpuinfo), else the machine name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() in ("flags", "Features"):
                    return " ".join(sorted(val.split()))
    except OSError:
        pass
    return platform.machine()


def so_path(cpu_flags: str | None = None) -> str:
    """Where the library for these sources, flags and CPU lives."""
    h = hashlib.sha256()
    for path in (_SRC, _TABLES):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CFLAGS + LIBS).encode())
    h.update((host_cpu_flags() if cpu_flags is None else cpu_flags).encode())
    return os.path.join(_BUILD_DIR, f"libxevejax-{h.hexdigest()[:16]}.so")


def build(so: str) -> None:
    """Compile to a private temporary name, then rename into place, so
    processes building at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.check_call(["gcc", *CFLAGS, "-o", tmp, _SRC, *LIBS])
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    so = so_path()
    if not os.path.exists(so):
        build(so)
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.xt_encode_intra_frame.restype = ctypes.c_int
    lib.xt_encode_intra_frame.argtypes = [
        ctypes.POINTER(XtFrameCfg), i16p, i16p, i16p,
        u8p, u8p, u8p, u8p, u8p,      # split maps 2..6
        u8p, u8p, u8p, u8p, u8p,      # mode maps 2..6
        i8p,                          # per-SCU AQ offsets or NULL
        u8p, ctypes.c_int64,
        u16p, u16p, u16p,
        ctypes.POINTER(XtStats),
    ]
    lib.xt_encode_main_intra_frame.restype = ctypes.c_int
    lib.xt_encode_main_intra_frame.argtypes = \
        lib.xt_encode_intra_frame.argtypes
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.xt_encode_frame.restype = ctypes.c_int
    lib.xt_encode_frame.argtypes = [
        ctypes.POINTER(XtFrameCfg),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # slice_type, poc, pad_l
        i16p, i16p, i16p,
        ctypes.POINTER(XtRefPic), ctypes.c_int32,         # L0 list, count
        ctypes.POINTER(XtRefPic), ctypes.c_int32,         # L1 list, count
        ctypes.POINTER(u8p), ctypes.POINTER(u8p),         # split/mode map tables
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),       # mv/mv1 map tables
        ctypes.POINTER(i32p), ctypes.POINTER(i32p),       # mv0b/mv1b (refi=1)
        ctypes.POINTER(i32p),                             # mvbi (bi-refined L1)
        ctypes.POINTER(ctypes.c_int8),                    # per-SCU AQ offsets
        u8p, ctypes.c_int64,
        u16p, u16p, u16p,
        i32p, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(XtStats),
    ]
    _lib = lib
    return lib
