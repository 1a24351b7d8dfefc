"""K-mer extraction, counting, and set subtraction — the Jellyfish replacement.

Reference behavior being re-implemented (SURVEY.md §2 #7): the reference
shells out to ``jellyfish count/merge/dump`` on (a) cleaned sample reads,
(b) the cached region reference fasta, (c) optional normal reads
(reference: utils.py run_jellyfish), loads the text dumps into Python
dicts, and computes ``sample_only = sample - reference - normal`` with dict
ops (reference: sv_processor.py target.compare_kmers), dropping low-count
k-mers.

Device design: no dicts, no files. A k-mer is a 2k-bit integer code
(k<=15 fits uint32). Extraction is k static shift-or steps over a padded
[R, L] base-code tensor; counting and subtraction are sort + segmented
run-length + binary-search ops over flat code vectors — all static-shape,
jit-compatible, with invalid slots carried as a sentinel code that sorts to
the end. The engine is deliberately XLA-level: the hot ops are sorts and
binary searches, which XLA lowers to its own sort and gather kernels.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel for invalid/padded kmer slots: max uint32, sorts after any real
# 2k-bit code (codes use at most 30 bits for k<=15). A NumPy scalar,
# NOT a jnp scalar: a module-level jax array would be created on the
# default backend at import time, before the CLI has chosen the device,
# and every jit that captures it would fetch it from there. (A bare
# Python int doesn't work either: weak typing overflows int32 at
# `jnp.where(..., SENTINEL)` use sites.)
SENTINEL = np.uint32(0xFFFFFFFF)
MAX_K_U32 = 15


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_codes(codes: jax.Array, lengths: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Extract all k-mer codes from a padded read batch.

    Args:
      codes:   [R, L] int8 base codes (0..3 real, 4 = N/pad).
      lengths: [R] int32 true read lengths.
      k:       static k-mer size (<= 15 for uint32 codes).

    Returns:
      (kmers [R, L-k+1] uint32, valid [R, L-k+1] bool). A window is valid
      iff it lies within the read and contains no N. Invalid slots hold
      SENTINEL.
    """
    if k > MAX_K_U32:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K_U32})")
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    acc = jnp.zeros((R, W), dtype=jnp.uint32)
    bad = jnp.zeros((R, W), dtype=bool)
    for j in range(k):
        window = codes[:, j : j + W]
        bad = bad | (window >= 4)
        acc = (acc << 2) | jnp.where(window >= 4, 0, window).astype(jnp.uint32)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    in_read = pos <= (lengths[:, None] - k)
    valid = in_read & ~bad
    return jnp.where(valid, acc, SENTINEL), valid


def kmer_codes_np(codes: np.ndarray, lengths: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host-numpy twin of :func:`kmer_codes` (tested for equality).

    The assembler needs the per-read k-mer codes on the HOST to build
    posting lists; for the few hundred short reads of a region, a numpy
    rolling evaluation takes microseconds and needs no device round trip.
    """
    if k > MAX_K_U32:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K_U32})")
    codes = np.asarray(codes, dtype=np.int8)
    lengths = np.asarray(lengths, dtype=np.int32)
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    acc = np.zeros((R, W), dtype=np.uint32)
    bad = np.zeros((R, W), dtype=bool)
    for j in range(k):
        window = codes[:, j : j + W]
        bad |= window >= 4
        acc = (acc << np.uint32(2)) | np.where(window >= 4, 0, window).astype(np.uint32)
    pos = np.arange(W, dtype=np.int32)[None, :]
    valid = (pos <= (lengths[:, None] - k)) & ~bad
    return np.where(valid, acc, SENTINEL), valid


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_kmers(codes: jax.Array, k: int) -> jax.Array:
    """Reverse-complement packed k-mer codes on device (SENTINEL maps to
    SENTINEL). Used to build the both-strand reference table without
    leaving HBM."""
    c = codes
    out = jnp.zeros_like(c)
    for _ in range(k):
        out = (out << 2) | (jnp.uint32(3) - (c & jnp.uint32(3)))
        c = c >> 2
    return jnp.where(codes == SENTINEL, SENTINEL, out)


@jax.jit
def sort_kmers(kmers: jax.Array) -> jax.Array:
    """Flatten and sort kmer codes; SENTINEL (invalid) slots sort last."""
    return jnp.sort(kmers.reshape(-1))


@jax.jit
def unique_counts_sorted(sorted_kmers: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Run-length encode a sorted code vector (static shape).

    Returns (values [N], counts [N], is_start [N]): at each run start,
    ``values`` holds the k-mer and ``counts`` its multiplicity; elsewhere
    values=SENTINEL, counts=0. This is the device-side analog of a
    jellyfish dump (SURVEY.md §2 #7) without leaving HBM.
    """
    n = sorted_kmers.shape[0]
    prev = jnp.concatenate([jnp.array([SENTINEL], dtype=sorted_kmers.dtype), sorted_kmers[:-1]])
    is_start = (sorted_kmers != prev) & (sorted_kmers != SENTINEL)
    idx = jnp.arange(n, dtype=jnp.int32)
    # run end = next run's start (or first sentinel position)
    valid = sorted_kmers != SENTINEL
    total_valid = jnp.sum(valid.astype(jnp.int32))
    # next start after each position: scan from the right
    nxt = jax.lax.associative_scan(
        jnp.minimum, jnp.where(is_start, idx, n), reverse=True
    )
    nxt_after = jnp.concatenate([nxt[1:], jnp.array([n], dtype=nxt.dtype)])
    run_end = jnp.minimum(jnp.where(nxt_after > idx, nxt_after, n), total_valid)
    counts = jnp.where(is_start, run_end - idx, 0).astype(jnp.int32)
    values = jnp.where(is_start, sorted_kmers, SENTINEL)
    return values, counts, is_start


@jax.jit
def member_sorted(queries: jax.Array, table_sorted: jax.Array) -> jax.Array:
    """For each query code, True iff present in the sorted table.

    ``table_sorted`` may contain SENTINEL padding (sorts last). SENTINEL
    queries return False. This is the set-membership half of the
    sample - reference - normal subtraction.
    """
    pos = jnp.searchsorted(table_sorted, queries)
    pos = jnp.clip(pos, 0, table_sorted.shape[0] - 1)
    hit = table_sorted[pos] == queries
    return hit & (queries != SENTINEL)


@jax.jit
def subtract_sorted(
    sample_values: jax.Array,
    sample_counts: jax.Array,
    ref_sorted: jax.Array,
    normal_sorted: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """sample_only = sample - reference [- normal], with counts preserved.

    Mirrors the reference's dict subtraction in target.compare_kmers but as
    vectorized binary searches over sorted tables. Returns (values, counts)
    with removed entries set to (SENTINEL, 0).
    """
    drop = member_sorted(sample_values, ref_sorted)
    if normal_sorted is not None:
        drop = drop | member_sorted(sample_values, normal_sorted)
    keep = (~drop) & (sample_values != SENTINEL)
    return (
        jnp.where(keep, sample_values, SENTINEL),
        jnp.where(keep, sample_counts, 0),
    )


# ---------------------------------------------------------------------------
# Host-side convenience wrappers (used by the per-region pipeline, which is
# host-driven between device stages; and by tests as a second opinion).
# ---------------------------------------------------------------------------

def sample_only_kmers(
    sample_codes: np.ndarray,
    sample_lengths: np.ndarray,
    ref_codes: np.ndarray,
    k: int,
    normal_codes: Optional[np.ndarray] = None,
    normal_lengths: Optional[np.ndarray] = None,
    min_count: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline: extract -> count -> subtract -> threshold.

    Args mirror target.compare_kmers inputs: sample read batch, region
    reference sequence (single row), optional normal read batch. Returns
    (kmer_codes uint32 sorted desc by count then asc by code, counts),
    host numpy arrays ready for the assembler.
    """
    s_km, _ = kmer_codes(jnp.asarray(sample_codes), jnp.asarray(sample_lengths), k)
    s_sorted = sort_kmers(s_km)
    values, counts, _ = unique_counts_sorted(s_sorted)

    ref = np.asarray(ref_codes, dtype=np.int8).reshape(1, -1)
    ref_len = jnp.asarray([ref.shape[1]], dtype=jnp.int32)
    r_km, _ = kmer_codes(jnp.asarray(ref), ref_len, k)
    # both strands: a sample read may come from either strand, and the
    # reference subtraction must treat a k-mer and its reverse complement
    # as reference-present (the reference tool counts canonical kmers via
    # jellyfish; SURVEY.md §2 #7)
    rc = _revcomp_codes_vec(np.asarray(r_km).reshape(-1), k)
    ref_table = jnp.sort(jnp.concatenate([r_km.reshape(-1), jnp.asarray(rc)]))

    normal_table = None
    if normal_codes is not None:
        n_km, _ = kmer_codes(jnp.asarray(normal_codes), jnp.asarray(normal_lengths), k)
        normal_table = sort_kmers(n_km)

    values, counts = subtract_sorted(values, counts, ref_table, normal_table)

    v = np.asarray(values)
    c = np.asarray(counts)
    keep = (v != np.uint32(0xFFFFFFFF)) & (c >= min_count)
    v, c = v[keep], c[keep]
    # deterministic order: count desc, then code asc (parity tie-break rule;
    # SURVEY.md §7 hard part 1)
    order = np.lexsort((v, -c.astype(np.int64)))
    return v[order], c[order]


def kmer_table(
    codes: np.ndarray, lengths: np.ndarray, k: int, add_rc: bool = True
) -> np.ndarray:
    """Sorted k-mer membership table (host numpy) over a read batch or a
    single sequence row; with ``add_rc`` the table is orientation-proof
    (contains every k-mer's reverse complement too)."""
    km, _ = kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), k)
    v = np.asarray(km).reshape(-1)
    v = v[v != SENTINEL]
    if add_rc:
        v = np.concatenate([v, _revcomp_codes_vec(v, k)])
    return np.sort(v)


def _member_host(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    if len(table) == 0:
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(table, values).clip(0, len(table) - 1)
    return table[idx] == values


def novel_kmer_normal_support(
    contig_codes: np.ndarray,
    ref_table: np.ndarray,
    normal_table: np.ndarray,
    k: int,
) -> Tuple[int, int]:
    """(n_novel, n_in_normal) for one contig: how many of the contig's
    non-reference (novel) k-mers appear in the matched normal.

    Germline evidence check (VERDICT r3): the k-mer subtraction operates
    on RAW sample reads, so two sample reads sharing one sequencing error
    create a count-2 error k-mer absent from the normal that recruits the
    germline junction reads; the assembled CONSENSUS is the clean germline
    sequence, whose novel k-mers the normal DOES contain — recheck the
    contig against the normal table post-assembly."""
    row = np.asarray(contig_codes, dtype=np.int8).reshape(1, -1)
    km, _ = kmer_codes(
        jnp.asarray(row), jnp.asarray([row.shape[1]], dtype=jnp.int32), k
    )
    v = np.asarray(km).reshape(-1)
    v = np.unique(v[v != SENTINEL])
    novel = v[~_member_host(v, ref_table)]
    if len(novel) == 0:
        return 0, 0
    return len(novel), int(np.sum(_member_host(novel, normal_table)))


def _revcomp_codes_vec(codes_u32: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed k-mer codes (vectorized, host)."""
    codes = codes_u32.astype(np.uint64)
    out = np.zeros_like(codes)
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (codes & np.uint64(3)))
        codes >>= np.uint64(2)
    sent = codes_u32 == np.uint32(0xFFFFFFFF)
    out = out.astype(np.uint32)
    out[sent] = np.uint32(0xFFFFFFFF)
    return out


def kmer_to_str(code: int, k: int) -> str:
    """Decode a k-mer code back to its ACGT string (debug/report aid)."""
    bases = "ACGT"
    out = []
    for shift in range(2 * (k - 1), -2, -2):
        out.append(bases[(int(code) >> shift) & 3])
    return "".join(out)


def str_to_kmer(s: str) -> int:
    code = 0
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    for ch in s.upper():
        code = (code << 2) | lut[ch]
    return code
