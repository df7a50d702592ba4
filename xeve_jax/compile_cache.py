"""Persistent JAX compilation cache, configured in one place.

Every entry point (the CLI, bench.py, chip_smoke.py, __graft_entry__.py,
the test suite's conftest) calls configure() before its first compile.
JAX itself reads JAX_COMPILATION_CACHE_DIR into
`jax_compilation_cache_dir`; when that variable is set nothing is changed
here.  Otherwise the cache lives at the fixed path <repo>/.jax_cache, so a
later process on the same checkout finds what an earlier one compiled.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    import jax
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return jax.config.jax_compilation_cache_dir
    if jax.config.jax_compilation_cache_dir != REPO_CACHE_DIR:
        os.makedirs(REPO_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
