"""Test config: JAX runs on a virtual 8-device CPU mesh so the sharding
tests run without accelerators.  Must run before any jax import.

JAX_PLATFORMS picks the backend and defaults to cpu here.  Tests marked
`gpu` need a card: they skip unless JAX's first device is a GPU, so on a
GPU host run them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# pin the platform at the config level too, in case jax was imported
# before this file set the variable
import jax
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xeve_jax import compile_cache

compile_cache.configure()

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def load_yuv8(path, w, h, frame=0):
    fsz = w * h * 3 // 2
    raw = np.fromfile(path, dtype=np.uint8)[frame * fsz:(frame + 1) * fsz]
    y = raw[:w * h].reshape(h, w).astype(np.int32)
    u = raw[w * h:w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int32)
    v = raw[w * h + w * h // 4:].reshape(h // 2, w // 2).astype(np.int32)
    return y, u, v


def load_rec10(path, w, h, frame=0):
    fsz = w * h * 3 // 2
    raw = np.fromfile(path, dtype='<u2')[frame * fsz:(frame + 1) * fsz]
    y = raw[:w * h].reshape(h, w).astype(np.int32)
    u = raw[w * h:w * h + w * h // 4].reshape(h // 2, w // 2).astype(np.int32)
    v = raw[w * h + w * h // 4:].reshape(h // 2, w // 2).astype(np.int32)
    return y, u, v


@pytest.fixture
def data_dir():
    return DATA


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips unless JAX's first device is one")
