"""The Hopper Smith-Waterman kernel (native/sw_cuda.cu) as a JAX operation.

Same contract as ops.sw.sw_score, bit for bit: q [..., Lq] and t [..., Lt]
int8 codes (4 = pad/N) in, (score, q_end, t_end) int32 [...] out. Leading
axes are folded into the kernel's batch, so the call works under
``jax.vmap`` (``vmap_method="broadcast_all"``) and, per device, under
``shard_map``. One launch scores every pair with the DP state held in
registers for the whole sweep (see the .cu header for the layout).

The shared library is compiled from the committed source with ``nvcc`` at
first use, into native/build/ (gitignored), and registered as an XLA FFI
target for CUDA. A failed build raises: there is no silent fallback.
ops.sw.sw_score_auto decides when this kernel serves a call.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from breakmer_tpu.ops.sw import SWParams

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE / "sw_cuda.cu"
_LIB = _NATIVE / "build" / "libbreakmer_sw_cuda.so"
TARGET = "breakmer_sw_score"
# query rows one warp holds (32 lanes x 32 rows); a longer query is swept
# in tiles of this many rows, with the last row of each tile carried to
# the next through a [B, Lt] (H, F) buffer
TILE_ROWS = 1024

_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{_SRC.name}")


def build() -> Path:
    """The kernel library, compiled for sm_90a (see native.build_shared_lib)."""
    from breakmer_tpu.native import build_shared_lib

    return build_shared_lib(_SRC, _LIB, lambda out: [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", str(out), str(_SRC),
    ])


def register() -> None:
    """Build the library if needed and register its FFI target (once)."""
    global _registered
    if _registered:
        return
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.BreakmerSwScore), platform="CUDA"
    )
    _registered = True


def carry_shape(batch: Tuple[int, ...], Lq: int, Lt: int) -> Tuple[int, ...]:
    """Shape of the kernel's scratch result: the carried (H, F) row per
    target column when the query spans more than one tile, else a
    one-element placeholder."""
    return (*batch, 2 * Lt) if Lq > TILE_ROWS else (*batch, 1)


def sw_score_cuda(
    q: jax.Array, t: jax.Array, params: SWParams = SWParams()
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Best local-alignment (score, q_end, t_end) per pair on the GPU."""
    if jax.default_backend() == "gpu":
        register()
    batch = q.shape[:-1]
    if t.shape[:-1] != batch:
        raise ValueError(f"q and t batch shapes differ: {q.shape} vs {t.shape}")
    Lq, Lt = q.shape[-1], t.shape[-1]
    out = jax.ShapeDtypeStruct(batch, jnp.int32)
    carry = jax.ShapeDtypeStruct(carry_shape(batch, Lq, Lt), jnp.int32)
    score, q_end, t_end, _ = jax.ffi.ffi_call(
        TARGET, (out, out, out, carry), vmap_method="broadcast_all"
    )(
        q.astype(jnp.int8), t.astype(jnp.int8),
        match=np.int32(params.match), mismatch=np.int32(params.mismatch),
        gap_open=np.int32(params.gap_open),
        gap_extend=np.int32(params.gap_extend),
    )
    return score, q_end, t_end
