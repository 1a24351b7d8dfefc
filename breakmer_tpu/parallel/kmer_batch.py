"""Batched multi-region k-mer step (BASELINE.json config #3).

The serial runner pays one device dispatch per region; this step packs G
regions into one fixed-shape launch (parallel/regions.py pack) and runs
the whole panel's k-mer extract/count/subtract in a single jit —
optionally sharded over the device mesh ("regions" axis), which is the
device analog of the reference's multiprocessing pool (SURVEY.md §2b).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import numpy as np

from breakmer_tpu.parallel.mesh import AXIS_REGIONS
from breakmer_tpu.parallel.regions import RegionBatch
from breakmer_tpu.parallel.step import _per_region_kmers

_SENTINEL = np.uint32(0xFFFFFFFF)


# packed-fetch budget: valid sample-only kmers per region are typically
# tens (post min_count subtraction), so 512 slots/region is generous; a
# kmer-richer batch overflows the buffer, which the step reports (n=-1)
# and the host retries with the full-shape fetch — bit-exact either way
_PACK_SLOTS_PER_REGION = 512


def _compact_outputs(values, counts, cap: int):
    """Device-side compaction of the [G, K] kmer outputs (mostly sentinel
    padding) into (vals[cap] u32, gc[cap] u32 = gid<<24|count, n i32).

    The full [G, K] pair is ~1 MB per 32-region launch while the valid
    entries are a few KB, so only those are fetched. n=-1 signals overflow (n>cap or a count >= 2^24): caller refetches
    full shapes. Pure gather/scatter — bit-exact."""
    import jax.numpy as jnp

    G, K = values.shape
    assert G <= 256, "gid field is 8 bits; split batches above 256 regions"
    flat_v = values.reshape(-1)
    flat_c = counts.reshape(-1)
    valid = (flat_v != jnp.uint32(0xFFFFFFFF)) & (flat_c > 0)
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    dest = jnp.where(valid, pos, cap)  # invalid -> dropped by mode="drop"
    out_v = jnp.zeros(cap, jnp.uint32).at[dest].set(flat_v, mode="drop")
    gid = (jnp.arange(G * K, dtype=jnp.uint32) // jnp.uint32(K)) << 24
    gc = gid | flat_c.astype(jnp.uint32)
    out_gc = jnp.zeros(cap, jnp.uint32).at[dest].set(gc, mode="drop")
    n = jnp.sum(valid.astype(jnp.int32))
    bad = (n > cap) | (jnp.max(flat_c, initial=0) >= (1 << 24))
    return out_v, out_gc, jnp.where(bad, jnp.int32(-1), n)


def _kmer_body(k: int, min_count: int, mesh_id: Optional[int],
               with_normal: bool) -> Callable:
    """The un-jitted [G,...] -> (values [G,K], counts [G,K]) callable,
    shard_mapped over the regions axis when a mesh is attached."""
    body = jax.vmap(functools.partial(_per_region_kmers, k=k, min_count=min_count))
    n_in = 6 if with_normal else 4
    mesh = _MESHES.get(mesh_id) if mesh_id is not None else None
    if mesh is None:
        return body
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    spec = P(AXIS_REGIONS)
    return shard_map(
        lambda *a: tuple(
            jax.lax.all_gather(o, AXIS_REGIONS, axis=0, tiled=True)
            for o in body(*a)
        ),
        mesh=mesh,
        in_specs=(spec,) * n_in,
        out_specs=(P(), P()),
        check_vma=False,
    )


def _in_shardings(mesh_id: Optional[int], n_in: int):
    mesh = _MESHES.get(mesh_id) if mesh_id is not None else None
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec as P

    return tuple(NamedSharding(mesh, P(AXIS_REGIONS)) for _ in range(n_in))


@functools.lru_cache(maxsize=32)
def _compiled_kmer_step(k: int, min_count: int, mesh_id: Optional[int],
                        with_normal: bool = False) -> Callable:
    """Full-shape step: (values [G,K], counts [G,K]). Overflow-fallback
    path of the packed step; also the identity oracle in tests."""
    body = _kmer_body(k, min_count, mesh_id, with_normal)
    shardings = _in_shardings(mesh_id, 6 if with_normal else 4)
    if shardings is None:
        return jax.jit(body)
    return jax.jit(body, in_shardings=shardings)


@functools.lru_cache(maxsize=32)
def _compiled_kmer_step_packed(k: int, min_count: int,
                               mesh_id: Optional[int],
                               with_normal: bool, cap: int) -> Callable:
    """Packed step: same compute, compacted outputs for the cheap fetch."""
    body = _kmer_body(k, min_count, mesh_id, with_normal)

    def fn(*a):
        return _compact_outputs(*body(*a), cap)

    shardings = _in_shardings(mesh_id, 6 if with_normal else 4)
    if shardings is None:
        return jax.jit(fn)
    return jax.jit(fn, in_shardings=shardings)


_MESHES: Dict[int, jax.sharding.Mesh] = {}


def _postprocess(batch: RegionBatch, values: np.ndarray, counts: np.ndarray):
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g, name in enumerate(batch.names):
        if not name:
            continue
        v = values[g]
        c = counts[g]
        keep = (v != _SENTINEL) & (c > 0)
        v, c = v[keep], c[keep]
        order = np.lexsort((v, -c.astype(np.int64)))
        out[name] = (v[order], c[order])
    return out


def _postprocess_packed(batch: RegionBatch, vals: np.ndarray,
                        gcs: np.ndarray, n: int):
    """Packed-fetch twin of _postprocess: same valid-entry set, same
    per-region (count desc, code asc) order — identity-tested."""
    vals = vals[:n]
    gcs = gcs[:n]
    gid = gcs >> 24
    cnt = (gcs & np.uint32(0x00FFFFFF)).astype(np.int32)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g, name in enumerate(batch.names):
        if not name:
            continue
        m = gid == g
        v = vals[m]
        c = cnt[m]
        order = np.lexsort((v, -c.astype(np.int64)))
        out[name] = (v[order], c[order])
    return out


class KmerBatchPipeline:
    """Incremental batched k-mer stage: regions are added as host
    extraction finishes them; whenever a pad-tier group fills, its packed
    batch is DISPATCHED immediately (JAX dispatch is async), so device
    k-mer compute overlaps the host's extraction of later regions — and
    ``results()`` yields per-batch outputs as their fetches complete, so
    host assembly of early batches overlaps device compute of late ones
    (VERDICT r1 #4: host/device pipeline overlap). Region-level results
    are identical to run_kmer_batches (same pack, same step, same
    postprocess) — only the launch schedule changes."""

    def __init__(self, k: int, min_count: int = 2,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 regions_per_batch: int = 8):
        from breakmer_tpu.parallel.regions import tier_key

        self.k = k
        self.min_count = min_count
        self.mesh = mesh
        self.rpb = regions_per_batch
        self._tier_key = tier_key
        self._buffers: Dict[tuple, list] = {}
        self._pending: list = []
        self._mesh_id = None
        if mesh is not None:
            self._mesh_id = id(mesh)
            _MESHES[self._mesh_id] = mesh

    def add(self, name: str, batch, ref, normal=None) -> None:
        key = self._tier_key(batch, ref, normal, normal is not None)
        buf = self._buffers.setdefault(key, [])
        buf.append((name, batch, ref, normal))
        if len(buf) >= self.rpb:
            self._dispatch(list(buf))
            buf.clear()

    def _dispatch(self, members) -> None:
        from breakmer_tpu.parallel.regions import pack_region_batches
        from breakmer_tpu.utils.meter import METER

        with METER.stage("kmer_device"):
            (b,) = pack_region_batches(members, self.rpb)
            with_normal = b.normal_reads is not None
            cap = b.reads.shape[0] * _PACK_SLOTS_PER_REGION
            step = _compiled_kmer_step_packed(
                self.k, self.min_count, self._mesh_id, with_normal, cap,
            )
            args = (b.reads, b.lengths, b.refs, b.ref_lengths)
            if with_normal:
                args += (b.normal_reads, b.normal_lengths)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                spec = NamedSharding(self.mesh, P(AXIS_REGIONS))
                args = tuple(jax.device_put(x, spec) for x in args)
            else:
                from breakmer_tpu.device import commit_local

                args = commit_local(*args)
            self._pending.append((b, step(*args), args, with_normal))

    def results(self):
        """Flush partial groups, then yield {region: (values, counts)}
        per batch. ONE device_get for every pending packed output, so
        both the buffer count and (via the packed step) the byte count
        of the fetch are kept minimal. A packed buffer that overflowed
        (n=-1) is recomputed with the full-shape step — rare, bit-exact."""
        from breakmer_tpu.utils.meter import METER

        for buf in self._buffers.values():
            if buf:
                self._dispatch(list(buf))
                buf.clear()
        with METER.stage("kmer_device"):
            fetched = jax.device_get([out for _, out, _a, _wn in self._pending])
        for (b, _, args, with_normal), (vals, gcs, n) in zip(
            self._pending, fetched
        ):
            if int(n) < 0:  # packed overflow: full-shape refetch
                with METER.stage("kmer_device"):
                    full = _compiled_kmer_step(
                        self.k, self.min_count, self._mesh_id,
                        with_normal=with_normal,
                    )
                    values, counts = jax.device_get(full(*args))
                yield _postprocess(b, values, counts)
            else:
                yield _postprocess_packed(b, vals, gcs, int(n))
        self._pending = []

    def finish(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        merged: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for d in self.results():
            merged.update(d)
        return merged


def run_kmer_batch(
    batch: RegionBatch,
    k: int,
    min_count: int = 2,
    mesh: Optional[jax.sharding.Mesh] = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """One device launch for G regions; returns per-region sample-only
    k-mers as {region_name: (values desc-by-count, counts)} — the same
    host-side contract as ops.kmer.sample_only_kmers, ready for the
    assembler. The in-device reference subtraction covers both strands;
    batches built with a matched normal (RegionBatch.normal_reads) add
    the in-device normal subtraction too (r2 — the r1 path fell back to
    serial whenever a normal BAM was configured)."""
    return run_kmer_batches([batch], k, min_count, mesh)


def run_kmer_batches(
    batches,
    k: int,
    min_count: int = 2,
    mesh: Optional[jax.sharding.Mesh] = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Pipelined multi-batch form: dispatch EVERY tier's launch before
    fetching anything (JAX dispatch is async), then one device_get for
    all outputs, so no batch waits for the previous one's fetch before
    it is dispatched."""
    from breakmer_tpu.utils.meter import METER

    with METER.stage("kmer_device"):
        return _run_kmer_batches(batches, k, min_count, mesh)


def _run_kmer_batches(batches, k, min_count, mesh):
    mesh_id = None
    if mesh is not None:
        mesh_id = id(mesh)
        _MESHES[mesh_id] = mesh
    batches = list(batches)

    def args_of(b):
        base = (b.reads, b.lengths, b.refs, b.ref_lengths)
        if b.normal_reads is not None:
            base += (b.normal_reads, b.normal_lengths)
        return base

    if mesh is not None:
        # explicit placement: under multi-process JAX, raw numpy args to a
        # jit are rejected; a NamedSharding over this process's (local)
        # mesh is fully addressable and matches the step's in_shardings
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = NamedSharding(mesh, P(AXIS_REGIONS))

        def place(b):
            return tuple(jax.device_put(x, spec) for x in args_of(b))
    else:
        from breakmer_tpu.device import commit_local

        def place(b):
            return commit_local(*args_of(b))

    placed = [place(b) for b in batches]
    pending = [
        _compiled_kmer_step_packed(
            k, min_count, mesh_id, b.normal_reads is not None,
            b.reads.shape[0] * _PACK_SLOTS_PER_REGION,
        )(*args)
        for b, args in zip(batches, placed)
    ]
    fetched = jax.device_get(pending)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for b, args, (vals, gcs, n) in zip(batches, placed, fetched):
        if int(n) < 0:  # packed overflow: full-shape refetch (bit-exact)
            full = _compiled_kmer_step(
                k, min_count, mesh_id, with_normal=b.normal_reads is not None
            )
            values, counts = jax.device_get(full(*args))
            out.update(_postprocess(b, values, counts))
        else:
            out.update(_postprocess_packed(b, vals, gcs, int(n)))
    return out
