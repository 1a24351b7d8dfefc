"""Device selection and the persistent compile cache.

The reference has no accelerator at all; this module is the single place
the framework decides where compute lands. Policy (Config.device):

  "auto" (default): JAX's default backend — the GPU when JAX finds one,
      else the CPU. A backend that fails to start fails the run.
  "cpu": force the CPU backend (tests; CPU reference runs).
  "gpu": require the GPU; set-up fails when JAX finds none.

The CPU backend stays available beside the GPU, so a process can run one
jitted function on both (chip_smoke.py compares them).

Must be called before the first JAX computation of the process.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEVICES = ("auto", "cpu", "gpu")

_configured: str | None = None


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else
    the fixed repo-local ``.jax_cache`` (gitignored)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        Path(__file__).resolve().parent.parent / ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Persistent XLA compile cache: repeat compiles of the same program
    are read back instead of rebuilt."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def set_platform(device: str = "auto") -> None:
    """Set jax_platforms WITHOUT initializing the XLA backend — safe to
    call before jax.distributed.initialize (which must itself precede any
    backend-initialising call). configure() probes devices afterwards."""
    if device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    enable_compile_cache()
    if device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif device == "gpu":
        jax.config.update("jax_platforms", "cuda,cpu")


def configure(device: str = "auto") -> str:
    """Select the backend; returns the platform in use. Raises when the
    backend cannot start or ``device="gpu"`` finds no GPU."""
    global _configured
    if _configured is None:
        set_platform(device)
        _configured = jax.devices()[0].platform
    if device in ("cpu", "gpu") and _configured != device:
        raise RuntimeError(
            f"device={device!r} requested but this process runs on "
            f"{_configured!r}"
        )
    return _configured


def device_count() -> int:
    return len(jax.devices())


def commit_local(*arrays):
    """Commit host arrays to this process's first local device.

    Under multi-process JAX (jax.distributed initialized), jit treats
    uncommitted numpy args as GLOBAL inputs and refuses them; committing
    to a local device keeps the computation process-local — which is this
    framework's multihost model: regions are partitioned across processes
    and each process runs its own device pipeline (SURVEY.md §2b), only
    the call-set merge crosses processes.
    """
    if jax.process_count() <= 1:
        return arrays if len(arrays) != 1 else arrays[0]
    dev = jax.local_devices()[0]
    out = tuple(jax.device_put(a, dev) for a in arrays)
    return out if len(out) != 1 else out[0]
