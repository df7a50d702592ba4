"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, and
otherwise lives at the fixed <repo>/.jax_cache."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "import jax; from xeve_jax import compile_cache; "
         "print(compile_cache.configure()); "
         "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(**env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", PROBE, ROOT], env=env,
                       capture_output=True, text=True, check=True,
                       cwd=ROOT, timeout=300)
    returned, configured = r.stdout.strip().splitlines()[-2:]
    assert returned == configured
    return configured


def test_compile_cache_follows_env(tmp_path):
    assert _cache_dir(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == \
        str(tmp_path)


def test_compile_cache_defaults_to_repo():
    assert _cache_dir() == os.path.join(ROOT, ".jax_cache")
