"""chip_smoke.py's phases at a tiny size on the CPU backend: the same
code the GPU run executes, with the CPU standing in for the card (so the
device-vs-CPU agreement is trivially 1 here; the GPU run measures it)."""
import numpy as np
import pytest

import chip_smoke

W, H = 128, 64


@pytest.fixture
def fake_gpu(monkeypatch):
    """require_gpu() as on a GPU host, so xeve_jax_app's --analysis auto
    picks the device engine on the CPU backend."""
    import xeve_jax.device

    def info():
        d = xeve_jax.device.device_info()
        return dict(d, platform="gpu", nvidia_smi="none")
    monkeypatch.setattr(xeve_jax.device, "require_gpu", info)


def test_kernel_checks_tiny():
    out = chip_smoke.check_kernels(W, H, strip_h=H)
    assert set(out) == {"fused_I_vs_numpy", "fused_P_dev_vs_cpu",
                        "fused_B_dev_vs_cpu", "main_vs_numpy",
                        "inter_jax_dev_vs_cpu"}
    assert min(out.values()) >= chip_smoke.BOUND_I_VS_TWIN


def test_encodes_tiny_decode_bit_exact(fake_gpu, tmp_path):
    chip_smoke.CompileCounter.install()
    deps = (("RA", W, H, 17, 0, 15, 0, "device"),
            ("AI app", W, H, 3, 1, 0, 0, "auto"),
            ("LD-P", W, H, 4, 0, 0, 0, "device"),
            ("Main AI", W, H, 2, 1, 0, 1, "jax"))
    res = dict(chip_smoke.run_encodes(deps, workdir=str(tmp_path)))
    assert res["AI app"]["engine"] == "device"
    assert res["RA"]["decoded_aus"] == 17 and res["LD-P"]["decoded_aus"] == 3
    for r in res.values():
        assert r["compiles"] == 0 and r["failures"] == 0
        assert r["psnr_y"] > 30.0 and r["kbps"] > 0


def test_decode_check_catches_a_wrong_recon(monkeypatch):
    chip_smoke.CompileCounter.install()
    real = chip_smoke.decode_hashes
    monkeypatch.setattr(chip_smoke, "decode_hashes", lambda s: {
        poc: h + ("x" if poc == 1 else "") for poc, h in real(s).items()})
    with pytest.raises(chip_smoke.SmokeFailure, match="decode differs"):
        chip_smoke.run_encodes((("LD-P", W, H, 2, 0, 0, 0, "device"),))


def test_meshed_phase_tiny():
    chip_smoke.CompileCounter.install()
    out = chip_smoke.run_meshed(4, W, H, 17)
    assert out["fps_one"] > 0 and out["fps_mesh"] > 0


def test_trace_phase_tiny(tmp_path):
    s = chip_smoke.run_trace(W, H, 17, trace_dir=str(tmp_path / "tr"))
    assert s["frames"] == 17
    assert not (tmp_path / "tr").exists()
    for d in s["devices"].values():
        assert 0.0 <= d.get("idle_share", 0.0) <= 1.0
