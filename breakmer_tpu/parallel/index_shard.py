"""Mesh-sharded genome seed index — the distributed gfServer analog.

SURVEY.md §2b lists two deployments for the whole-genome k-mer index that
replaces the reference's resident gfServer (sv_caller.py gfClient legs,
runner.start_blat_server): (v1) replicated per host — ``align.index.
GenomeIndex`` — and (v2) sharded across devices with collective lookups.
This module is v2: the sorted (code, position, chrom) seed table is
RANGE-SHARDED along the code axis over a 1-D device mesh; a query batch
is replicated (it is tiny — one contig's k-mers — next to the table),
every shard answers with a local binary search, and one ``all_gather``
over the shard axis merges the hits. That collective (NVLink, all to
all, between the cards of one machine) replaces the reference's
localhost gfServer socket hop, and the sharding is what lets a dense
(step=1) index of a real genome — tens of GB of seed table — live in
aggregate device memory when no single card could hold it.

Parity: candidate windows are identical to GenomeIndex.candidates by
construction — the table shards are built FROM the per-chromosome
SeedIndexes (same max-hits capping), device hits are re-ordered to the
host lookup's (q_pos asc, t_pos asc) order, and clustering goes through
align.index.cluster_candidates, the exact code path the replicated index
uses. Tested for equality on a virtual CPU mesh.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from breakmer_tpu.align.index import GenomeIndex, Window, _seed_codes, cluster_candidates
from breakmer_tpu.encode import revcomp_codes

AXIS_SHARDS = "shards"
SENT_CODE = np.int64(1 << 62)  # sorts after every real 2k-bit seed code


def make_shard_mesh(n_devices: Optional[int] = None):
    import jax

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.array(devices), (AXIS_SHARDS,))


def _lookup_local(codes_l, pos_l, chrom_l, queries, h_pad: int, axis: str):
    """Per-shard lookup body (runs under shard_map): binary-search the
    local code range, emit up to h_pad (position, chrom) hits per query
    plus the true local count (overflow detection)."""
    import jax
    import jax.numpy as jnp

    n_l = codes_l.shape[0]
    lo = jnp.searchsorted(codes_l, queries, side="left")
    hi = jnp.searchsorted(codes_l, queries, side="right")
    take = lo[:, None] + jnp.arange(h_pad, dtype=lo.dtype)[None, :]
    valid = take < hi[:, None]
    takec = jnp.clip(take, 0, n_l - 1)
    hpos = jnp.where(valid, pos_l[takec], -1)
    hchrom = jnp.where(valid, chrom_l[takec], -1)
    counts = (hi - lo).astype(jnp.int32)
    hpos = jax.lax.all_gather(hpos, axis)      # [D, Q, H]
    hchrom = jax.lax.all_gather(hchrom, axis)
    counts = jax.lax.all_gather(counts, axis)  # [D, Q]
    return hpos, hchrom, counts


class ShardedGenomeIndex:
    """Device-sharded wrapper over a built GenomeIndex.

    ``candidates`` has the same contract as GenomeIndex.candidates (and
    returns identical windows); ``fetch_codes`` delegates to the host
    genome copy (window sequences are fetched per winner — on a real
    multi-host deployment the 2-bit genome is replicated per host while
    the far larger seed table is the sharded part, SURVEY.md §2b).
    """

    def __init__(self, genome: GenomeIndex, mesh=None, h_pad: Optional[int] = None):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        self._genome = genome
        self.k = genome.k
        self.mesh = mesh if mesh is not None else make_shard_mesh()
        self._chrom_names: List[str] = list(genome.chroms)
        parts_c, parts_p, parts_id = [], [], []
        per_chrom = genome.per_chrom_seed_arrays()
        for cid, chrom in enumerate(self._chrom_names):
            ccodes, cpos = per_chrom[chrom]
            parts_c.append(ccodes.astype(np.int64))
            parts_p.append(cpos.astype(np.int64))
            parts_id.append(np.full(len(ccodes), cid, dtype=np.int64))
        codes = np.concatenate(parts_c) if parts_c else np.empty(0, np.int64)
        pos = np.concatenate(parts_p) if parts_p else np.empty(0, np.int64)
        cid = np.concatenate(parts_id) if parts_id else np.empty(0, np.int64)
        # global sort by code; stable keeps (chrom, position) order within
        # a code run, matching the per-chrom hit order after the host-side
        # (q_pos, t_pos) re-sort
        order = np.argsort(codes, kind="stable")
        codes, pos, cid = codes[order], pos[order], cid[order]
        if h_pad is None:
            # exact per-shard capacity: the longest global code run (a
            # seed capped at 64/chrom can still hit 64*n_chroms in ONE
            # shard after the range sharding — a fixed 128 overflowed on
            # >=3-chromosome genomes, found by review repro)
            if len(codes):
                starts = np.r_[0, np.nonzero(codes[1:] != codes[:-1])[0] + 1]
                h_pad = int(np.diff(np.r_[starts, len(codes)]).max())
            else:
                h_pad = 1
        self.h_pad = max(1, h_pad)
        D = self.mesh.devices.size
        n_pad = max(D, ((len(codes) + D - 1) // D) * D)
        padn = n_pad - len(codes)
        if padn:
            codes = np.concatenate([codes, np.full(padn, SENT_CODE)])
            pos = np.concatenate([pos, np.full(padn, -1, np.int64)])
            cid = np.concatenate([cid, np.full(padn, -1, np.int64)])
        spec = NamedSharding(self.mesh, P(AXIS_SHARDS))
        self._codes_d = jax.device_put(codes, spec)
        self._pos_d = jax.device_put(pos, spec)
        self._cid_d = jax.device_put(cid, spec)
        self._lookup = self._build_lookup()

    def _build_lookup(self):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = self.mesh
        h_pad = self.h_pad

        def body(codes_l, pos_l, chrom_l, queries):
            return _lookup_local(codes_l, pos_l, chrom_l, queries, h_pad, AXIS_SHARDS)

        from jax import shard_map

        sharded = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(AXIS_SHARDS), P(AXIS_SHARDS), P(AXIS_SHARDS), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def lookup(self, query_codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All (q_index, chrom_id, t_pos) seed hits for a query-code
        vector, via the sharded collective. Raises on per-shard overflow
        (a query k-mer with more than h_pad hits inside one shard)."""
        import jax.numpy as jnp

        q = np.asarray(query_codes, dtype=np.int64)
        if len(q) == 0:
            return (np.empty(0, np.int64),) * 3
        hpos, hchrom, counts = self._lookup(
            self._codes_d, self._pos_d, self._cid_d, jnp.asarray(q)
        )
        counts = np.asarray(counts)
        if counts.max(initial=0) > self.h_pad:
            raise OverflowError(
                f"seed run exceeds h_pad={self.h_pad} in one shard; "
                "raise h_pad (per-chrom max_hits_per_seed bounds total hits)"
            )
        hpos = np.asarray(hpos)      # [D, Q, H]
        hchrom = np.asarray(hchrom)
        valid = hpos >= 0
        d_i, q_i, _h = np.nonzero(valid)
        return q_i.astype(np.int64), hchrom[valid], hpos[valid]

    def candidates(self, query_codes: np.ndarray, **kw) -> List[Window]:
        max_windows = kw.get("max_windows", 8)
        L = len(query_codes)
        per_chrom_hits: Dict[str, list] = {c: [] for c in self._chrom_names}
        # ONE device round trip for both strands: concatenate the strand
        # query vectors and split the hits by query index afterwards
        fw_codes, fw_pos = _seed_codes(np.asarray(query_codes, np.int8), self.k)
        rc_codes, rc_pos = _seed_codes(revcomp_codes(query_codes), self.k)
        qi, cid, tp = self.lookup(np.concatenate([fw_codes, rc_codes]))
        n_fw = len(fw_codes)
        for strand, sel_s, q_pos, off in (
            ("+", qi < n_fw, fw_pos, 0),
            ("-", qi >= n_fw, rc_pos, n_fw),
        ):
            qp_all = q_pos[qi[sel_s] - off] if sel_s.any() else qi[:0]
            cid_s, tp_s = cid[sel_s], tp[sel_s]
            for c_i, chrom in enumerate(self._chrom_names):
                sel = cid_s == c_i
                if not sel.any():
                    per_chrom_hits[chrom].append((strand, tp_s[:0], tp_s[:0]))
                    continue
                cqp, ctp = qp_all[sel], tp_s[sel]
                # host lookup order: q_pos asc, then position asc in run
                o = np.lexsort((ctp, cqp))
                per_chrom_hits[chrom].append((strand, cqp[o], ctp[o]))
        out: List[Window] = []
        for chrom in self._chrom_names:
            wins = cluster_candidates(
                per_chrom_hits[chrom], self._genome.length(chrom), L, **kw
            )
            for w in wins:
                w.chrom = chrom
                out.append(w)
        out.sort(key=lambda w: (-w.nseeds, w.chrom, w.t_start, w.strand))
        return out[:max_windows]

    # -- host-side delegates (same surface as GenomeIndex) ------------------
    @property
    def chroms(self) -> List[str]:
        return self._chrom_names

    def fetch_codes(self, chrom: str, start: int, end: int) -> np.ndarray:
        return self._genome.fetch_codes(chrom, start, end)

    def length(self, chrom: str) -> int:
        return self._genome.length(chrom)
