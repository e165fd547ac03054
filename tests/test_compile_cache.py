"""Where the package puts JAX's persistent compile cache."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRINT_CACHE = ("import metacherchant_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(**env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_extra)
    proc = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=env,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    return proc.stdout.strip().splitlines()[-1]


def test_cache_defaults_to_checkout_dir():
    assert _cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_follows_env_var(tmp_path):
    assert _cache_dir(JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)
