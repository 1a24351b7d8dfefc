"""Region scheduler: bucketing regions/reads into fixed-shape batches.

Reference: the region scheduler is runner.run's loop feeding a process
pool one region at a time (SURVEY.md §2 #3, #19). On the device the unit
of work must be a STATIC-shape tensor, so regions are packed into
[G, R_max, L_max] batches: G regions per device step, each padded to the
batch's read-count and read-length tiers (SURVEY.md §7 hard part 3 —
pad tiers bound recompiles).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from breakmer_tpu.encode import PAD, ReadBatch, pad_tier


@dataclasses.dataclass
class RegionBatch:
    """G regions packed to one device-step shape.

    reads   [G, R, L] int8  (PAD-filled)
    lengths [G, R]    int32 (0 for padding rows)
    nreads  [G]       int32
    refs    [G, Lref] int8  (PAD-filled)
    ref_lengths [G]   int32
    names   list of G region names
    normal_reads/normal_lengths: optional matched-normal read batch
        [G, Rn, Ln] / [G, Rn] for the in-device normal k-mer subtraction
        (None when the run has no normal BAM; empty pad rows where a
        region has no normal reads subtract nothing)
    """

    reads: np.ndarray
    lengths: np.ndarray
    nreads: np.ndarray
    refs: np.ndarray
    ref_lengths: np.ndarray
    names: List[str]
    normal_reads: np.ndarray = None
    normal_lengths: np.ndarray = None

    @property
    def shape_key(self) -> Tuple[int, ...]:
        g, r, l = self.reads.shape
        key = (g, r, l, self.refs.shape[1])
        if self.normal_reads is not None:
            key += self.normal_reads.shape[1:]
        return key


READ_COUNT_TIERS = (64, 128, 256, 512, 1024)
READ_LEN_TIERS = (128, 160, 256)
REF_LEN_TIERS = (1024, 2048, 4096, 8192)


def tier_key(
    batch: ReadBatch,
    ref: np.ndarray,
    normal,
    with_normal: bool,
    read_count_tiers: Sequence[int] = READ_COUNT_TIERS,
    read_len_tiers: Sequence[int] = READ_LEN_TIERS,
    ref_len_tiers: Sequence[int] = REF_LEN_TIERS,
) -> Tuple:
    """Pad-tier signature of one region — regions sharing a key pack
    into the same fixed-shape batch (used by pack_region_batches and the
    incremental KmerBatchPipeline; one definition so they always agree)."""
    key = (
        pad_tier(max(1, len(batch)), read_count_tiers),
        pad_tier(max(1, batch.max_len), read_len_tiers),
        pad_tier(max(1, len(ref)), ref_len_tiers),
    )
    if with_normal:
        nb = normal if normal is not None else None
        key += (
            pad_tier(max(1, len(nb) if nb else 1), read_count_tiers),
            pad_tier(max(1, nb.max_len if nb and len(nb) else 1),
                     read_len_tiers),
        )
    return key


def pack_region_batches(
    regions: Sequence[Tuple],
    regions_per_batch: int = 8,
    read_count_tiers: Sequence[int] = READ_COUNT_TIERS,
    read_len_tiers: Sequence[int] = READ_LEN_TIERS,
    ref_len_tiers: Sequence[int] = REF_LEN_TIERS,
) -> List[RegionBatch]:
    """Pack (name, read batch, region ref codes[, normal batch]) tuples
    into fixed-shape RegionBatches. Regions are grouped by their pad-tier
    signature so one oversized region does not inflate every batch, then
    chunked to ``regions_per_batch`` (G is padded up with empty regions
    so every batch in a group shares a shape). The optional 4th element
    (matched-normal ReadBatch or None) makes every batch in the run carry
    normal arrays, empty where absent."""
    regions = [tuple(r) + (None,) * (4 - len(r)) for r in regions]
    with_normal = any(r[3] is not None for r in regions)
    grouped: Dict[Tuple, List[Tuple]] = {}
    for name, batch, ref, normal in regions:
        key = tier_key(batch, ref, normal, with_normal,
                       read_count_tiers, read_len_tiers, ref_len_tiers)
        grouped.setdefault(key, []).append((name, batch, ref, normal))

    out: List[RegionBatch] = []
    for key, members in grouped.items():
        R, L, Lref = key[:3]
        for i in range(0, len(members), regions_per_batch):
            chunk = members[i : i + regions_per_batch]
            G = regions_per_batch
            reads = np.full((G, R, L), PAD, dtype=np.int8)
            lengths = np.zeros((G, R), dtype=np.int32)
            nreads = np.zeros((G,), dtype=np.int32)
            refs = np.full((G, Lref), PAD, dtype=np.int8)
            ref_lengths = np.zeros((G,), dtype=np.int32)
            names = []
            n_reads_arr = n_len_arr = None
            if with_normal:
                Rn, Ln = key[3], key[4]
                n_reads_arr = np.full((G, Rn, Ln), PAD, dtype=np.int8)
                n_len_arr = np.zeros((G, Rn), dtype=np.int32)
            for g, (name, batch, ref, normal) in enumerate(chunk):
                r = len(batch)
                reads[g, :r, : batch.max_len] = batch.codes
                lengths[g, :r] = batch.lengths
                nreads[g] = r
                refs[g, : len(ref)] = ref
                ref_lengths[g] = len(ref)
                names.append(name)
                if with_normal and normal is not None and len(normal):
                    rn = len(normal)
                    n_reads_arr[g, :rn, : normal.max_len] = normal.codes
                    n_len_arr[g, :rn] = normal.lengths
            names += [""] * (G - len(chunk))
            out.append(
                RegionBatch(reads, lengths, nreads, refs, ref_lengths, names,
                            n_reads_arr, n_len_arr)
            )
    return out
