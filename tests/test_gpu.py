"""Tests that need a GPU.  Each decides inside the test whether JAX's
first device is one and skips otherwise; on a GPU host run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` (chip_smoke.py runs
the same checks)."""
import pytest


def _require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")


@pytest.mark.gpu
def test_device_analyzers_agree_at_1080p():
    """Fused analyzer I frame vs the numpy twin, its P/B frames and the
    jax inter engine vs JAX's CPU backend, Main EIPD vs its numpy twin:
    1920x1088 decisions within chip_smoke's stated bounds."""
    _require_gpu()
    import chip_smoke
    worst = chip_smoke.check_kernels()
    assert worst["fused_I_vs_numpy"] >= chip_smoke.BOUND_I_VS_TWIN
