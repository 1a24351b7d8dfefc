"""Batched affine-gap local alignment (Smith-Waterman) as an anti-diagonal
wavefront — the BLAT-DP replacement.

Reference behavior being replaced (SURVEY.md §2 #11): the reference shells
out to ``blat`` (contig vs region fasta) and ``gfClient``/``gfServer``
(contig vs whole genome) per contig, parsing PSL text. Here realignment is
a batched device op: many (contig, candidate-window) pairs are scored in
one launch.

Wavefront design (SURVEY.md §7 layer 4): all cells on an anti-diagonal
``d`` are independent; the DP state is only the last two diagonals of H and
the last diagonal of E and F, laid out as [B, Lq] vectors indexed by query
position i (cell (i, j=d-i)). Each step is a handful of elementwise ops
plus one shift and one dynamic slice of the reversed target — no gathers.
Scores are int32; positions of the best cell are tracked alongside.

The gap model: a gap of length g costs ``gap_open + gap_extend * g``
(first gapped base pays open+extend). Pad/N bases (code 4) make a cell
score -inf so padding never contaminates scores.

This module is the jit-level implementation: it runs on any backend, is
the test oracle's fast twin, and serves the CPU. ops/sw_cuda.py is the
GPU kernel with identical results; ``sw_score_auto`` picks between them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

NEG = -(1 << 28)


class SWParams(NamedTuple):
    match: int = 2
    mismatch: int = 3      # subtracted
    gap_open: int = 5      # first gapped base costs gap_open + gap_extend
    gap_extend: int = 1


def _shift_right(x: jax.Array, fill) -> jax.Array:
    """new[i] = old[i-1]; new[0] = fill.  (along the last axis)"""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, dtype=x.dtype), x[..., :-1]], axis=-1
    )


@functools.partial(jax.jit, static_argnames=("params",))
def sw_score(
    q: jax.Array,
    t: jax.Array,
    params: SWParams = SWParams(),
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Best local-alignment score per (query, target) pair.

    Args:
      q: [B, Lq] int8 base codes (4 = pad/N).
      t: [B, Lt] int8 base codes (4 = pad/N).
      params: static scoring parameters.

    Returns:
      (score [B] int32, q_end [B] int32, t_end [B] int32) — the maximal H
      cell and its (inclusive) end coordinates; all -1/-1 with score 0 when
      no positive-scoring cell exists.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    steps = Lq + Lt - 1

    qi = q.astype(jnp.int32)
    # reversed, padded target so each step's t[d-i] (i=0..Lq-1) is one
    # contiguous slice: t_ext[(Lq-1) + (Lt-1-d) + i] == t[d-i]
    t_rev = t[:, ::-1].astype(jnp.int32)
    pad = jnp.full((B, Lq - 1), 4, dtype=jnp.int32) if Lq > 1 else jnp.zeros((B, 0), jnp.int32)
    t_ext = jnp.concatenate([pad, t_rev, pad], axis=1)

    i_idx = jnp.arange(Lq, dtype=jnp.int32)[None, :]  # [1, Lq]

    def body(carry, d):
        h_d1, h_d2, e_d1, f_d1, best, best_i, best_j = carry
        # target base per lane: t[d - i]
        start = (Lq - 1) + (Lt - 1) - d
        tj = jax.lax.dynamic_slice_in_dim(t_ext, start, Lq, axis=1)
        sub = jnp.where(
            (qi >= 4) | (tj >= 4),
            NEG,
            jnp.where(qi == tj, params.match, -params.mismatch),
        )
        go = params.gap_open + params.gap_extend
        ge = params.gap_extend
        e_new = jnp.maximum(h_d1 - go, e_d1 - ge)               # from (i, j-1)
        f_new = jnp.maximum(
            _shift_right(h_d1, NEG) - go, _shift_right(f_d1, NEG) - ge
        )                                                        # from (i-1, j)
        h_diag = _shift_right(h_d2, 0)                           # from (i-1, j-1)
        # boundary: cell (0, j) has diag neighbor H(-1, j-1) = 0 — covered by
        # the fill value 0 above; cell (i, 0) has diag neighbor H(i-1,-1)=0:
        j_idx = d - i_idx
        h_diag = jnp.where(j_idx == 0, 0, h_diag)
        e_new = jnp.where(j_idx == 0, NEG, e_new)
        h_new = jnp.maximum(
            jnp.maximum(h_diag + sub, 0), jnp.maximum(e_new, f_new)
        )
        in_bounds = (j_idx >= 0) & (j_idx < Lt)
        h_new = jnp.where(in_bounds, h_new, 0)
        e_new = jnp.where(in_bounds, e_new, NEG)
        f_new = jnp.where(in_bounds, f_new, NEG)

        step_best = jnp.max(h_new, axis=1)
        step_arg = jnp.argmax(h_new, axis=1).astype(jnp.int32)
        upd = step_best > best
        best = jnp.where(upd, step_best, best)
        best_i = jnp.where(upd, step_arg, best_i)
        best_j = jnp.where(upd, d - step_arg, best_j)
        return (h_new, h_d1, e_new, f_new, best, best_i, best_j), None

    h0 = jnp.zeros((B, Lq), dtype=jnp.int32)
    ef0 = jnp.full((B, Lq), NEG, dtype=jnp.int32)
    best0 = jnp.zeros((B,), dtype=jnp.int32)
    pos0 = jnp.full((B,), -1, dtype=jnp.int32)
    (_, _, _, _, best, best_i, best_j), _ = jax.lax.scan(
        body, (h0, h0, ef0, ef0, best0, pos0, pos0), jnp.arange(steps, dtype=jnp.int32)
    )
    none = best <= 0
    return (
        jnp.where(none, 0, best),
        jnp.where(none, -1, best_i),
        jnp.where(none, -1, best_j),
    )


def sw_impl(platform: str, params: SWParams = SWParams()) -> str:
    """The SW implementation that serves ``platform``: "cuda" (the
    ops.sw_cuda kernel) on the GPU, "scan" (``sw_score``) elsewhere. The
    kernel's boundary handling assumes non-negative gap penalties, so
    other parameters take the scan on every platform."""
    if platform in ("gpu", "cuda") and params.gap_open >= 0 and params.gap_extend >= 0:
        return "cuda"
    return "scan"


def sw_score_auto(
    q: jax.Array, t: jax.Array, params: SWParams = SWParams()
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """SW on whatever platform the computation is lowered for: the CUDA
    kernel on the GPU, the XLA scan elsewhere (``sw_impl``). The choice
    is made at lowering, so one jitted function serves a GPU and a CPU
    device alike; the two are tested for exact agreement."""
    scan = functools.partial(sw_score, params=params)
    if sw_impl("cuda", params) == "scan":
        return scan(q, t)
    from breakmer_tpu.ops.sw_cuda import sw_score_cuda

    kernel = functools.partial(sw_score_cuda, params=params)
    return jax.lax.platform_dependent(q, t, cuda=kernel, default=scan)


def sw_score_batch(q, t, params: SWParams = SWParams()):
    """Convenience for host drivers: numpy in, numpy out, one device_get
    for all three outputs. Meters the launch under the implementation
    that served it."""
    import time as _time

    from breakmer_tpu.device import commit_local
    from breakmer_tpu.utils.meter import METER

    t0 = _time.perf_counter()
    qd, td = commit_local(jnp.asarray(q), jnp.asarray(t))
    out = sw_score_auto(qd, td, params)
    res = tuple(jax.device_get(out))
    METER.add_sw(q.shape[0] * q.shape[1] * t.shape[1], _time.perf_counter() - t0,
                 sw_impl(jax.default_backend(), params))
    return res
