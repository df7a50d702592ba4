"""The device the encoder runs on, as JAX and nvidia-smi report it.

Measurement entry points (bench.py, chip_smoke.py) call require_gpu():
they fail when JAX comes up without a GPU instead of measuring the CPU.
"""
from __future__ import annotations

import shutil
import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGpuError(RuntimeError):
    """JAX found no GPU."""


def parse_nvidia_smi(text: str) -> list[dict]:
    """Rows of `nvidia-smi --query-gpu=name,power.limit --format=csv,
    noheader` as [{"name": ..., "power_limit": ...}], one per card.  The
    name may itself hold commas, so the limit is the last field; a line
    without one (a note that nvidia-smi failed) is no card."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if "," not in line:
            continue
        name, _, limit = line.rpartition(",")
        rows.append({"name": name.strip(), "power_limit": limit.strip()})
    return rows


def nvidia_smi() -> str:
    """The query's output as printed (one line per card), or a note saying
    why there is none."""
    if shutil.which(NVIDIA_SMI_QUERY[0]) is None:
        return "nvidia-smi not found"
    r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        err = r.stderr.strip().replace(",", ";")    # no card row
        return f"nvidia-smi failed (rc {r.returncode}): {err}"
    return r.stdout.strip()


def device_info() -> dict:
    """JAX's first device: platform, device_kind and the device count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info() plus the nvidia-smi output, as printed and as parsed
    rows ("cards"); raises NoGpuError unless JAX's first device is a GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise NoGpuError(f"JAX found no GPU: its first device is "
                         f"{info['platform']} ({info['kind']})")
    info["nvidia_smi"] = nvidia_smi()
    info["cards"] = parse_nvidia_smi(info["nvidia_smi"])
    return info
