"""The sharded device step: fused k-mer subtraction + batched SW scoring
over a mesh.

This is the multi-chip analog of one pass of the reference's per-region
worker body (SURVEY.md §3.2-3.3 hot stages), minus the host-side assembly
that sits between them:

  in:  reads [G, R, L] + region refs [G, Lref]   sharded over "regions"
       SW pairs q [G, B, Lq] / t [G, B, Lt]      sharded over
                                                 ("regions", "pairs")
  out: per-region sample-only k-mer values/counts, merged (all-gather
       over "regions" — the call-set merge collective), and SW scores
       (all-gather over "pairs" then "regions")

XLA inserts the collectives from the shard_map specs; between the cards
of one machine they run over NVLink, all to all. The same function jits
unsharded for single-card use (``make_region_step(mesh=None)``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from breakmer_tpu.ops.kmer import (
    SENTINEL, kmer_codes, revcomp_kmers, sort_kmers, subtract_sorted,
    unique_counts_sorted,
)
from breakmer_tpu.ops.sw import SWParams, sw_score, sw_score_auto
from breakmer_tpu.parallel.mesh import AXIS_PAIRS, AXIS_REGIONS


def _per_region_kmers(reads, lengths, ref, ref_length,
                      normal_reads=None, normal_lengths=None,
                      *, k: int, min_count: int):
    """One region: sample-only k-mer values/counts (static shapes).
    ``normal_reads``/``normal_lengths`` add the in-device matched-normal
    subtraction (same semantics as ops.kmer.sample_only_kmers: one-strand
    normal table — normal reads already cover both strands). A region
    with no normal reads passes all-PAD rows, whose k-mer table is all
    sentinels and subtracts nothing."""
    km, _ = kmer_codes(reads, lengths, k)
    s = sort_kmers(km)
    values, counts, _ = unique_counts_sorted(s)
    rkm, _ = kmer_codes(ref[None, :], ref_length[None], k)
    rkm = rkm.reshape(-1)
    table = jnp.sort(jnp.concatenate([rkm, revcomp_kmers(rkm, k)]))
    normal_table = None
    if normal_reads is not None:
        nkm, _ = kmer_codes(normal_reads, normal_lengths, k)
        normal_table = sort_kmers(nkm)
    values, counts = subtract_sorted(values, counts, table, normal_table)
    keep = counts >= min_count
    return (
        jnp.where(keep, values, SENTINEL),
        jnp.where(keep, counts, 0),
    )


def make_region_step(
    mesh: Optional[jax.sharding.Mesh] = None,
    k: int = 15,
    min_count: int = 2,
    params: SWParams = SWParams(),
) -> Callable:
    """Build the jitted (optionally sharded) region step.

    Signature of the returned fn:
      step(reads [G,R,L] i8, lengths [G,R] i32, refs [G,Lref] i8,
           ref_lengths [G] i32, q [G,B,Lq] i8, t [G,B,Lt] i8)
        -> (kmer_values [G,N] u32, kmer_counts [G,N] i32,
            scores [G,B] i32, q_end [G,B] i32, t_end [G,B] i32)
    """

    def body(reads, lengths, refs, ref_lengths, q, t):
        values, counts = jax.vmap(
            functools.partial(_per_region_kmers, k=k, min_count=min_count)
        )(reads, lengths, refs, ref_lengths)
        sw = functools.partial(sw_score_auto, params=params)
        scores, q_end, t_end = jax.vmap(sw)(q, t)
        if mesh is not None:
            # merge collectives: pairs-axis gather completes each region's
            # SW batch; regions-axis gather is the call-set merge
            scores = jax.lax.all_gather(scores, AXIS_PAIRS, axis=1, tiled=True)
            q_end = jax.lax.all_gather(q_end, AXIS_PAIRS, axis=1, tiled=True)
            t_end = jax.lax.all_gather(t_end, AXIS_PAIRS, axis=1, tiled=True)
            scores = jax.lax.all_gather(scores, AXIS_REGIONS, axis=0, tiled=True)
            q_end = jax.lax.all_gather(q_end, AXIS_REGIONS, axis=0, tiled=True)
            t_end = jax.lax.all_gather(t_end, AXIS_REGIONS, axis=0, tiled=True)
            values = jax.lax.all_gather(values, AXIS_REGIONS, axis=0, tiled=True)
            counts = jax.lax.all_gather(counts, AXIS_REGIONS, axis=0, tiled=True)
        return values, counts, scores, q_end, t_end

    if mesh is None:
        return jax.jit(body)

    from jax import shard_map

    region_spec = P(AXIS_REGIONS)
    pair_spec = P(AXIS_REGIONS, AXIS_PAIRS)
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(region_spec, region_spec, region_spec, region_spec,
                  pair_spec, pair_spec),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    in_shardings = (
        NamedSharding(mesh, region_spec),
        NamedSharding(mesh, region_spec),
        NamedSharding(mesh, region_spec),
        NamedSharding(mesh, region_spec),
        NamedSharding(mesh, pair_spec),
        NamedSharding(mesh, pair_spec),
    )
    return jax.jit(sharded, in_shardings=in_shardings)
