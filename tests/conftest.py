"""Test configuration.

Run the suite on the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/``.
The CPU backend gets 8 virtual devices so multi-device sharding paths run
without several cards (SURVEY.md §4.4), and the persistent compilation
cache (``breakmer_tpu.device.cache_dir``) lets repeat runs skip XLA
compiles.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; the ``gpu``
fixture decides, at run time. ``python chip_smoke.py`` runs them on the
card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from breakmer_tpu.device import enable_compile_cache  # noqa: E402  (after the env setup)

enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
