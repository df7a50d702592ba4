"""chip_smoke.py on the CPU: its output contract, its refusal to run
without a GPU, and the trace reduction it reports."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from xeve_jax.device import parse_nvidia_smi

ROOT = chip_smoke.ROOT


def test_final_line_is_the_exact_json_contract():
    line = chip_smoke.final_line({"platform": "gpu",
                                  "kind": "NVIDIA H100 80GB HBM3",
                                  "count": 1, "nvidia_smi": "ignored"})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("text,rows", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit": "500.00 W"},
      {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]),
    ("Card, with comma, 350.00 W", [{"name": "Card, with comma",
                                     "power_limit": "350.00 W"}]),
    ("", []),
    ("nvidia-smi not found", []),
])
def test_nvidia_smi_parser(text, rows):
    assert parse_nvidia_smi(text) == rows


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_app_auto_refuses_cpu():
    import xeve_jax_app
    from xeve_jax.device import NoGpuError
    with pytest.raises(NoGpuError):
        xeve_jax_app.choose_analysis("auto", "baseline")
    assert xeve_jax_app.choose_analysis("numpy", "main")[0] == "numpy"


def test_union_of_intervals():
    assert chip_smoke.union_ns([]) == 0
    assert chip_smoke.union_ns([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert chip_smoke.union_ns([(0, 100), (10, 20)]) == 100


def test_trace_summary_ranks_ops_and_idle_share():
    ev = [("fusion.1", 0, 10), ("fusion.2", 5, 10), ("dot.3", 40, 25),
          ("fusion.1", 90, 10)]
    s = chip_smoke.summarize_device_events(ev, window=(0, 200), top=2)
    assert s["busy_ns"] == 50 and s["window_ns"] == 200
    assert s["idle_share"] == pytest.approx(1 - 50 / 200)
    assert s["window_from"] == "traced encode"
    assert [t["name"] for t in s["top"]] == ["dot.3", "fusion.1"]
    assert s["top"][1]["count"] == 2
    # a window that does not hold the events falls back to their span
    s = chip_smoke.summarize_device_events(ev, window=(50, 60))
    assert s["window_from"] == "device span" and s["window_ns"] == 100
    assert chip_smoke.summarize_device_events([]) == {"events": 0}
