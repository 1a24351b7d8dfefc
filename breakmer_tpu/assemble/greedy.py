"""Greedy k-mer-extension contig assembly — the parity engine.

Reference behavior being re-implemented (SURVEY.md §2 #9, reference:
sv_assembly.py init_assembly / kmer_tracker / contig / buffer classes):

  * sample-only k-mers are processed in count-descending order;
  * a contig is seeded from the reads containing the top unused k-mer;
  * candidate reads are aligned to the contig by locating the shared
    k-mer (string find) and offset-stacking;
  * consensus is the per-position argmax of base counts;
  * the contig maintains a live k-mer set over its consensus so extension
    chains outward (reference: contig.refresh_kmers);
  * a buffer marks used reads/k-mers so each read seeds at most one contig;
  * contigs with fewer than ``min_contig_reads`` supporting reads are
    dropped.

Deterministic tie-break rules (pinned explicitly because the reference is
not runnable to diff against — SURVEY.md §7 hard part 1):
  * k-mer order: count desc, then code ascending;
  * read order within a k-mer: batch (input) order, then position asc;
  * consensus ties: base with the smaller code (A < C < G < T);
  * newly discovered k-mers are enqueued in consensus scan order
    (left to right).

This is intentionally a host-side implementation: assembly is inherently
sequential and data-dependent (SURVEY.md §7 hard part 2); the device does
the heavy lifting before (k-mer subtraction) and after (realignment). The
read-vs-contig inner matching uses the precomputed k-mer -> (read, pos)
posting lists from the device k-mer pass rather than rescanning reads.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from breakmer_tpu import native as _native
from breakmer_tpu.encode import ReadBatch, decode_seq
from breakmer_tpu.ops import kmer as kmer_ops


@dataclasses.dataclass
class ContigRead:
    """A read placed in a contig; ``offset`` is the contig coordinate of
    the read's first base (may have been clipped if negative during
    growth — offsets are re-based to 0 at finalize)."""

    name: str
    index: int        # row in the source ReadBatch
    offset: int
    length: int


@dataclasses.dataclass
class Contig:
    id: str
    seq: str
    reads: List[ContigRead]
    kmers: List[int]  # sample-only k-mer codes contained in the consensus

    @property
    def nreads(self) -> int:
        return len(self.reads)


class _Growing:
    """Mutable contig under construction: a dense base-count (position
    vote) matrix over an integer coordinate axis that may extend in both
    directions. Vectorized — the per-base dict loop was a measured hot
    spot of the warm panel path; semantics unchanged (uncovered positions
    decode to N, argmax ties pick the smaller base code). The per-row
    argmax is maintained INCREMENTALLY: each add_read re-derives only the
    rows it voted on (counts never decrease, so untouched rows cannot
    change), replacing the full-matrix argmax the old consensus() ran
    after every single read placement."""

    __slots__ = ("counts", "out", "lo")

    def __init__(self):
        self.counts = np.zeros((0, 4), dtype=np.int32)  # rows: lo..lo+span
        self.out = np.zeros(0, dtype=np.int8)           # per-row argmax (4=uncovered)
        self.lo = 0  # contig coordinate of counts[0]

    def add_read(self, codes: np.ndarray, offset: int) -> None:
        codes = np.asarray(codes, dtype=np.int8)
        n = len(codes)
        if n == 0 or not (codes < 4).any():
            return
        if len(self.counts) == 0:
            self.lo = offset
            self.counts = np.zeros((n, 4), dtype=np.int32)
            self.out = np.full(n, 4, dtype=np.int8)
        else:
            grow_left = self.lo - offset
            if grow_left > 0:
                self.counts = np.vstack(
                    [np.zeros((grow_left, 4), dtype=np.int32), self.counts]
                )
                self.out = np.r_[np.full(grow_left, 4, dtype=np.int8), self.out]
                self.lo = offset
            grow_right = (offset + n) - (self.lo + len(self.counts))
            if grow_right > 0:
                self.counts = np.vstack(
                    [self.counts, np.zeros((grow_right, 4), dtype=np.int32)]
                )
                self.out = np.r_[self.out, np.full(grow_right, 4, dtype=np.int8)]
        real = codes < 4
        if not real.any():
            # a read contributing zero non-N bases has nothing to vote on
            # (placed reads are kmer-anchored so this is defensive only)
            return
        pos = (offset - self.lo) + np.nonzero(real)[0]
        np.add.at(self.counts, (pos, codes[real].astype(np.intp)), 1)
        # re-derive the touched rows (argmax tie -> smaller base code,
        # np.argmax picks the first max; all rows here are now covered)
        a, b = int(pos[0]), int(pos[-1]) + 1
        seg = self.counts[a:b]
        self.out[a:b] = np.where(
            seg.any(axis=1), np.argmax(seg, axis=1), 4
        ).astype(np.int8)

    def consensus(self) -> Tuple[np.ndarray, int]:
        """(consensus base codes, start coordinate). Gaps in coverage
        (possible only transiently) stay code 4 (N)."""
        if len(self.counts) == 0:
            return np.zeros(0, dtype=np.int8), 0
        covered = self.out < 4
        # trim leading/trailing uncovered coordinates (the dict version
        # only spanned covered min..max)
        nz = np.nonzero(covered)[0]
        if not len(nz):
            return np.zeros(0, dtype=np.int8), 0
        lo_i, hi_i = int(nz[0]), int(nz[-1])
        return self.out[lo_i : hi_i + 1], self.lo + lo_i


def _build_postings(
    kmers: np.ndarray, valid: np.ndarray
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """kmer code -> (read_indices, positions) in deterministic order
    (read asc, then position asc). Array-valued postings: the r1
    per-entry python tuple loop was the hottest host line of the warm
    panel profile; consumers zip the two arrays on demand."""
    reads_idx, pos_idx = np.nonzero(valid)
    codes = kmers[reads_idx, pos_idx]
    order = np.lexsort((pos_idx, reads_idx, codes))
    codes_s = codes[order]
    r_s = reads_idx[order]
    p_s = pos_idx[order]
    bounds = np.r_[
        0, np.nonzero(codes_s[1:] != codes_s[:-1])[0] + 1, len(codes_s)
    ]
    postings: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        postings[int(codes_s[a])] = (r_s[a:b], p_s[a:b])
    return postings


def _mismatches(a: np.ndarray, b: np.ndarray) -> int:
    usable = (a < 4) & (b < 4)
    return int(np.sum((a != b) & usable))


_EMPTY = np.empty(0, dtype=np.int64)

_ENC_LUT = np.full(256, 4, dtype=np.int8)
for _ch, _cc in zip(b"ACGT", range(4)):
    _ENC_LUT[_ch] = _cc


def _consensus_kmers(codes: np.ndarray, k: int) -> "np.ndarray":
    """(codes, positions) of all valid kmers of a consensus base-code
    array — vectorized rolling evaluation (replaces per-kmer str scans
    in the grow loop)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    # one windowed dot product instead of a k-step shift-accumulate loop:
    # this runs ~350x per warm 100-gene panel and the old loop's ~4k numpy
    # dispatches were pure call overhead at consensus lengths (~500)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    bad = (win >= 4).any(axis=1)
    weights = np.left_shift(np.int64(1), 2 * np.arange(k - 1, -1, -1, dtype=np.int64))
    acc = win.astype(np.int64) @ weights  # code>=4 only where bad (masked out)
    pos = np.nonzero(~bad)[0]
    return acc[pos], pos


def assemble(
    kmer_values: np.ndarray,
    kmer_counts: np.ndarray,
    batch: ReadBatch,
    k: int,
    min_contig_reads: int = 2,
    min_contig_len: int = 20,
    max_read_mismatch_frac: float = 0.10,
    contig_id_prefix: str = "contig",
    use_native: bool = True,
) -> List[Contig]:
    """Assemble contigs from sample-only k-mers.

    Args:
      kmer_values/kmer_counts: output of ops.kmer.sample_only_kmers —
        already ordered count desc, code asc (the processing order).
      batch: the SV-informative reads.
      k: k-mer size used for kmer_values.
      use_native: route through the byte-identical C++ twin
        (native/breakmer_native.cc nat_assemble) when available; this
        Python body is the semantics oracle and the structural-equality
        tests in tests/test_native_assemble.py pin the two together.

    Returns contigs in creation order, each with per-read contig offsets
    (needed later for split-read support counting — SURVEY.md §2 #13).
    """
    if len(kmer_values) == 0 or len(batch) == 0:
        return []

    if use_native:
        nat = _native.assemble_greedy(
            batch.codes, batch.lengths, np.asarray(kmer_values, dtype=np.int64),
            k, min_contig_reads, min_contig_len, max_read_mismatch_frac,
        )
        if nat is not None:
            meta, reads_arr, kmers_arr, cons_arr = nat
            contigs: List[Contig] = []
            ri = ki = ci = 0
            for nr, nkm, clen in meta.tolist():
                reads = [
                    ContigRead(
                        batch.names[int(reads_arr[ri + j, 0])],
                        int(reads_arr[ri + j, 0]),
                        int(reads_arr[ri + j, 1]),
                        int(batch.lengths[reads_arr[ri + j, 0]]),
                    )
                    for j in range(nr)
                ]
                contigs.append(
                    Contig(
                        id=f"{contig_id_prefix}{len(contigs) + 1}",
                        seq=decode_seq(cons_arr[ci : ci + clen]),
                        reads=reads,
                        kmers=kmers_arr[ki : ki + nkm].tolist(),
                    )
                )
                ri += nr
                ki += nkm
                ci += clen
            return contigs

    # host twin of the device op: posting lists are consumed on the host,
    # so computing them there saves a device round trip per region
    km, valid = kmer_ops.kmer_codes_np(batch.codes, batch.lengths, k)
    postings = _build_postings(km, valid)

    sample_only = set(int(v) for v in kmer_values)
    kmer_used: set = set()
    read_used: set = set()
    contigs: List[Contig] = []

    for seed_code in (int(v) for v in kmer_values):
        if seed_code in kmer_used:
            continue
        sh_r, sh_p = postings.get(seed_code, (_EMPTY, _EMPTY))
        seed_hits = [
            (int(r), int(p)) for r, p in zip(sh_r.tolist(), sh_p.tolist())
            if r not in read_used
        ]
        if len(seed_hits) < min_contig_reads:
            kmer_used.add(seed_code)
            continue

        grow = _Growing()
        placed: List[ContigRead] = []
        placed_set: set = set()
        queue = deque([seed_code])
        queued = {seed_code}
        consensus = np.zeros(0, dtype=np.int8)  # base codes; str only at finalize
        cons_start = 0
        cons_kpos: Dict[int, int] = {}  # kmer code -> first consensus pos
        # seed read: first hit in deterministic order, anchored at its kmer
        # position so contig coordinate 0 is the seed read's first base
        first_r, first_p = seed_hits[0]

        def refresh_consensus() -> None:
            """Recompute the consensus kmer map and enqueue newly
            reachable sample-only kmers in scan (position) order —
            reference: contig.refresh_kmers."""
            nonlocal cons_kpos
            codes_arr, pos_arr = _consensus_kmers(consensus, k)
            cons_kpos = {}
            for c2, p2 in zip(codes_arr.tolist(), pos_arr.tolist()):
                if c2 not in cons_kpos:
                    cons_kpos[c2] = p2
                if c2 in sample_only and c2 not in queued:
                    queue.append(c2)
                    queued.add(c2)

        def place(read_idx: int, read_kpos: int, contig_kpos: int) -> bool:
            nonlocal consensus, cons_start
            if read_idx in placed_set:
                return False
            length = int(batch.lengths[read_idx])
            codes = batch.codes[read_idx, :length]
            offset = contig_kpos - read_kpos
            if len(consensus):
                # verify agreement over the overlap with current consensus
                c_lo = max(cons_start, offset)
                c_hi = min(cons_start + len(consensus), offset + length)
                if c_hi > c_lo:
                    cseg = consensus[c_lo - cons_start : c_hi - cons_start]
                    rseg = codes[c_lo - offset : c_hi - offset]
                    ov = c_hi - c_lo
                    if _mismatches(cseg, rseg) > max(2, int(max_read_mismatch_frac * ov)):
                        return False
            grow.add_read(codes, offset)
            placed.append(ContigRead(batch.names[read_idx], read_idx, offset, length))
            placed_set.add(read_idx)
            consensus, cons_start = grow.consensus()
            return True

        if place(first_r, first_p, 0):
            refresh_consensus()

        while queue:
            code = queue.popleft()
            kmer_used.add(code)
            # where does this kmer sit in the current consensus?
            cpos = cons_kpos.get(code)
            if cpos is None:
                continue
            contig_kpos = cons_start + cpos
            added = False
            h_r, h_p = postings.get(code, (_EMPTY, _EMPTY))
            for r, p in zip(h_r.tolist(), h_p.tolist()):
                if r in read_used or r in placed_set:
                    continue
                added |= place(r, p, contig_kpos)
            if added:
                refresh_consensus()

        if len(placed) >= min_contig_reads and len(consensus) >= min_contig_len:
            for cr in placed:
                read_used.add(cr.index)
            base = cons_start
            fk_codes, _ = _consensus_kmers(consensus, k)
            contigs.append(
                Contig(
                    id=f"{contig_id_prefix}{len(contigs) + 1}",
                    seq=decode_seq(consensus),
                    reads=[
                        ContigRead(cr.name, cr.index, cr.offset - base, cr.length)
                        for cr in placed
                    ],
                    # all sample-only kmers of the consensus, in scan order
                    # with duplicates kept (same as the per-position str
                    # scan this replaces)
                    kmers=[
                        int(c) for c in fk_codes.tolist() if c in sample_only
                    ],
                )
            )
    return contigs
