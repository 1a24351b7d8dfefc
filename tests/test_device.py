"""Device selection and the compile cache (breakmer_tpu.device).

Each check that sets the platform or the cache runs in a fresh process:
both are fixed once JAX's backend starts.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _python(code: str, **env) -> subprocess.CompletedProcess:
    full = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=full, timeout=120)


def test_unknown_device_rejected():
    from breakmer_tpu.device import set_platform

    with pytest.raises(ValueError, match="auto.*cpu.*gpu"):
        set_platform("cuda")


def test_gpu_device_fails_without_gpu():
    """device=gpu has no CPU fallback: set-up fails on a CPU-only host."""
    proc = _python("from breakmer_tpu.device import configure; configure('gpu')")
    assert proc.returncode != 0
    assert "device='gpu' requested" in proc.stderr


def test_compile_cache_follows_env(tmp_path):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from breakmer_tpu.device import configure\n"
        "configure('cpu')\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    cache = tmp_path / "cache"
    proc = _python(code, JAX_COMPILATION_CACHE_DIR=str(cache))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir())


def test_compile_cache_defaults_to_repo():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax\nfrom breakmer_tpu.device import configure\n"
         "configure('cpu')\nprint(jax.config.jax_compilation_cache_dir)\n"],
        capture_output=True, text=True, timeout=120,
        env=dict(env, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")
