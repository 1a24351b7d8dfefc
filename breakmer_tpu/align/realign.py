"""Seed-and-extend realignment driver: the blat/gfClient replacement.

Reference flow being replaced (SURVEY.md §3.3): per contig, the reference
writes a fasta, runs ``blat`` vs the region reference, falls back to
``gfClient`` -> ``gfServer`` (whole genome) when there is no clean
full-length hit, and parses PSL rows into ``blat_res`` objects; top-scoring
rows covering disjoint contig intervals become the split segments of an SV
event (reference: sv_caller.py ~1-800).

Here: candidate windows come from SeedIndex/GenomeIndex diagonal
clustering; all (contig, window) pairs are scored in one batched device SW
call (ops.sw — wavefront kernel); only winners get a host traceback.
Disjoint multi-segment discovery is iterative query masking: after a
segment is accepted, its contig interval is masked to N and the remainder
is realigned — deterministic, and uniform across deletion / duplication /
inversion / translocation shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from breakmer_tpu.align.index import GenomeIndex, SeedIndex, Window
from breakmer_tpu.align.traceback import (
    Alignment,
    rederive_fragmented_gaps,
    split_alignment,
    split_target_gap_junk,
    traceback_align,
)
from breakmer_tpu.encode import pad_tier, revcomp_codes
from breakmer_tpu.ops.sw import SWParams, sw_score_batch


@dataclasses.dataclass
class RegionRef:
    """The cached target-region reference (reference: utils.py
    extract_refseq_fa + target.set_ref_data): chrom, genomic start of the
    buffered region, base codes, and a seed index built once per region."""

    chrom: str
    start: int            # genomic coordinate of codes[0]
    codes: np.ndarray
    index: SeedIndex

    @classmethod
    def build(cls, chrom: str, start: int, codes: np.ndarray, seed_k: int = 11) -> "RegionRef":
        return cls(chrom=chrom, start=start, codes=np.asarray(codes, dtype=np.int8),
                   index=SeedIndex(codes, seed_k))


@dataclasses.dataclass
class AlignSegment:
    """One aligned contig segment in genomic coordinates — the blat_res
    equivalent (reference: sv_caller.py class blat_res, SURVEY.md §2 #12).

    q_start/q_end are FORWARD-contig coordinates (half-open) regardless of
    strand, so disjointness logic works across strands; t_start/t_end are
    genomic (half-open) on ``chrom``.
    """

    q_start: int
    q_end: int
    chrom: str
    t_start: int
    t_end: int
    strand: str
    score: int
    matches: int
    mismatches: int
    alignment: Alignment        # window-local, strand-oriented query coords
    in_target: bool = True
    repeat_frac: float = 0.0    # filled by the filter stack
    # best SW score among candidate windows at OTHER loci (genomically
    # disjoint from the winner) in the round that accepted this segment;
    # -1 = unknown (not produced by realign_contigs). Placement-uniqueness
    # evidence for the repeat filter's rescue path (call/filters.py):
    # a low runner-up means no competing locus explains this segment.
    # Margins are genome-aware in EVERY round (genome candidate windows
    # are scored from round 1 even though pass-1 PLACEMENT stays
    # region-only), and near-per-segment: each masked-requery round
    # re-gathers candidates for the remaining query only, so a
    # competitor recorded here competed for THIS segment's bases.
    second_score: int = -1
    # SW score of the ROUND winner that produced this segment: pieces cut
    # out of one winner traceback (split_alignment / gap-junk splitting)
    # inherit the round's second_score, so the rescue ratio test must
    # compare against the same whole-round scale, not the post-split
    # piece score (ADVICE r4 #2). -1 = unset -> callers fall back to
    # the piece score.
    round_score: int = -1

    @property
    def identity(self) -> float:
        aligned = self.matches + self.mismatches
        return self.matches / aligned if aligned else 0.0

    @property
    def q_span(self) -> int:
        return self.q_end - self.q_start

    def query_coverage(self, contig_len: int) -> float:
        return self.q_span / contig_len if contig_len else 0.0


@dataclasses.dataclass
class _Work:
    """Per-contig state across masked-requery rounds."""

    masked: np.ndarray
    region: RegionRef
    segments: List[AlignSegment]
    done: bool = False
    # reference two-pass structure (SURVEY.md §3.3): pass 1 is blat vs the
    # region only; the whole-genome index (gfServer analog) joins from the
    # second pass, or immediately when the region yields no candidates
    use_genome: bool = False
    # per-round candidate set (filled by _gather)
    windows: List[Window] = dataclasses.field(default_factory=list)
    window_codes: List[np.ndarray] = dataclasses.field(default_factory=list)
    n_region_windows: int = 0


def _min_fwd_span(q_end: int, score: int, strand: str, L: int,
                  match: int) -> Tuple[int, int]:
    """Minimal FORWARD-contig query interval a path with ``score`` ending
    at device best cell ``q_end`` (0-based inclusive, path orientation)
    must cover: at least ceil(score/match) query bases (all-match lower
    bound). Used to tell sibling-segment windows (disjoint query bases)
    from true competitors in the uniqueness margin (ADVICE r4 #1)."""
    if score <= 0:
        return (0, 0)
    m = min((score + match - 1) // match, q_end + 1)
    lo, hi = q_end + 1 - m, q_end + 1
    if strand == "+":
        return lo, hi
    return L - hi, L - lo


def _gather(work: _Work, genome: Optional[GenomeIndex]) -> bool:
    """Collect this round's candidate windows for one contig."""
    region = work.region
    work.windows = []
    work.window_codes = []
    for w in region.index.candidates(work.masked):
        work.windows.append(
            Window(w.t_start, w.t_end, w.strand, w.nseeds, chrom=region.chrom)
        )
        work.window_codes.append(region.codes[w.t_start : w.t_end])
    work.n_region_windows = len(work.windows)
    if genome is not None:
        for w in genome.candidates(work.masked):
            work.windows.append(w)
            work.window_codes.append(
                genome.fetch_codes(w.chrom, w.t_start, w.t_end)
            )
    return bool(work.windows)


def _process_winner(
    work: _Work,
    best: int,
    score: int,
    q_end: int,
    t_end: int,
    params: SWParams,
    min_seg_len: int,
    min_identity: float,
    min_seg_score: int,
    full_hit_cov: float,
    max_q_gap: int,
    second_score: int = -1,
) -> None:
    """Host traceback + accept/mask for one contig's round winner;
    updates work in place (sets done when no further rounds are useful)."""
    L = len(work.masked)
    region = work.region
    w = work.windows[best]
    codes = work.window_codes[best]
    is_region_window = best < work.n_region_windows
    # the device already located the best cell; the host DP only needs the
    # prefix up to it (exact — device/host agree bit-exactly)
    q_or = work.masked if w.strand == "+" else revcomp_codes(work.masked)
    qe = q_end + 1
    te = t_end + 1
    if 0 < qe <= len(q_or) and 0 < te <= len(codes):
        aln_whole = traceback_align(q_or[:qe], codes[:te], params)
    else:
        aln_whole = traceback_align(q_or, codes, params)
    if aln_whole.score <= 0:
        work.done = True
        return
    # blat-parity gap normalization: a fragmented multi-gap representation
    # (short unit-matched islands inside tandem arrays) re-derives to the
    # fewest-gaps form that explains >= the same matches (r4)
    aln_whole = rederive_fragmented_gaps(aln_whole, q_or, codes, params)
    # blat-parity: no giant query gaps inside one segment — split them
    pieces = split_alignment(aln_whole, q_or, codes, params, max_q_gap=max_q_gap)
    # cut deletion-sized TARGET gaps whose flank is paralog junk (below
    # min_identity): the junk side dies in the identity filter below and
    # masked requery places it at its true locus (r4 dup-as-del fix;
    # clean-flanked deletions are never split)
    pieces = [
        p2 for p in pieces
        for p2 in split_target_gap_junk(p, q_or, codes, params,
                                        min_identity=min_identity)
    ]
    made_progress = False
    for aln in pieces:
        if w.strand == "+":
            fq_start, fq_end = aln.q_start, aln.q_end
        else:
            fq_start, fq_end = L - aln.q_end, L - aln.q_start
        if fq_end - fq_start < min_seg_len and (work.segments or len(pieces) > 1):
            continue
        genomic_off = (region.start if is_region_window else 0) + w.t_start
        seg = AlignSegment(
            q_start=fq_start,
            q_end=fq_end,
            chrom=w.chrom or region.chrom,
            t_start=genomic_off + aln.t_start,
            t_end=genomic_off + aln.t_end,
            strand=w.strand,
            score=aln.score,
            matches=aln.matches,
            mismatches=aln.mismatches,
            alignment=aln,
            in_target=is_region_window,
            second_score=second_score,
            round_score=aln_whole.score,
        )
        if seg.identity < min_identity:
            continue
        work.segments.append(seg)
        made_progress = True
        work.masked = work.masked.copy()
        work.masked[fq_start:fq_end] = 4
    if not made_progress:
        work.done = True
        return
    covered = int(np.sum(work.masked >= 4))
    if covered >= L or (L - covered) < min_seg_len:
        work.done = True
        return
    if (
        len(work.segments) == 1
        and work.segments[0].query_coverage(L) >= full_hit_cov
    ):
        work.done = True


def realign_contigs(
    contigs: Sequence[Tuple[np.ndarray, RegionRef]],
    genome: Optional[GenomeIndex] = None,
    params: SWParams = SWParams(),
    max_segments: int = 3,
    min_seg_len: int = 25,
    min_identity: float = 0.90,
    min_seg_score: Optional[int] = None,
    full_hit_cov: float = 0.95,
    max_q_gap: int = 50,
    genome_margins: bool = True,
) -> List[List[AlignSegment]]:
    """Iteratively align MANY contigs, masking accepted segments — all
    contigs advance in lockstep rounds and every round's SW scoring of
    every (contig, candidate-window) pair across all contigs (and all
    regions, in the panel-batched runner) is ONE device launch instead
    of one launch per contig.

    Per-contig semantics are identical to the serial loop (the reference
    flow, SURVEY.md §3.3: blat-vs-region, genome fallback, greedy
    disjoint segments via query masking); results are byte-identical.

    ``genome_margins``: gather genome candidate windows in EVERY round so
    uniqueness margins (second_score) are genome-aware — required for the
    repeat filter's rescue, but ~3x warm realign cost on panels; callers
    disable it when no repeat mask is loaded (margins then stay -1 =
    unknown and the rescue never fires).
    """
    from breakmer_tpu.utils.meter import METER

    if min_seg_score is None:
        min_seg_score = params.match * min_seg_len // 2
    with METER.stage("realign"):
        return _realign_contigs(
            contigs, genome, params, max_segments, min_seg_len, min_identity,
            min_seg_score, full_hit_cov, max_q_gap, genome_margins,
        )


def _realign_contigs(
    contigs, genome, params, max_segments, min_seg_len, min_identity,
    min_seg_score, full_hit_cov, max_q_gap, genome_margins=True,
) -> List[List[AlignSegment]]:
    works = [
        _Work(np.asarray(codes, dtype=np.int8).copy(), region, [])
        for codes, region in contigs
    ]
    # bound: max_segments acceptance rounds + possible genome-retry rounds
    for _round in range(2 * max_segments + 1):
        active = [
            wk for wk in works
            if not wk.done
            and len(wk.segments) < max_segments
            and int(np.sum(wk.masked < 4)) >= min_seg_len
        ]
        for wk in active:
            # genome candidate windows are gathered EVERY round (not just
            # pass >= 2): placement still follows the reference's two-pass
            # structure (the winner is restricted to region windows in
            # pass 1 below), but the uniqueness margin (second_score) must
            # see genome-wide competitors — a region-only margin of 0
            # conflates "no disjoint candidate consulted" with "no
            # competitor exists" and let the repeat rescue fire on
            # round-1 segments whose paralogs were never scored (r4
            # review #1)
            if genome_margins or wk.use_genome:
                gathered = _gather(wk, genome)
                if not gathered:
                    wk.done = True
                elif wk.n_region_windows == 0:
                    # region pass empty -> genome placement right away
                    wk.use_genome = True
            else:
                # margins off: old two-pass gather (region-only pass 1)
                gathered = _gather(wk, None)
                if not gathered and genome is not None:
                    wk.use_genome = True
                    gathered = _gather(wk, genome)
                if not gathered:
                    wk.done = True
        active = [wk for wk in active if not wk.done]
        if not active:
            break
        # ---- ONE flat device launch over every candidate pair ------------
        flat_q: List[np.ndarray] = []
        flat_t: List[np.ndarray] = []
        spans: List[Tuple[int, int]] = []  # (start, count) per work item
        for wk in active:
            q_rc = revcomp_codes(wk.masked)
            spans.append((len(flat_q), len(wk.windows)))
            for w, codes in zip(wk.windows, wk.window_codes):
                flat_q.append(wk.masked if w.strand == "+" else q_rc)
                flat_t.append(codes)
        lq = pad_tier(max(len(q) for q in flat_q), (128, 256, 512, 1024))
        lt = pad_tier(max(len(t) for t in flat_t), (256, 512, 1024, 2048))
        B = len(flat_q)
        qb = np.full((B, lq), 4, dtype=np.int8)
        tb = np.full((B, lt), 4, dtype=np.int8)
        for b in range(B):
            qb[b, : len(flat_q[b])] = flat_q[b]
            tb[b, : len(flat_t[b])] = flat_t[b]
        scores, q_ends, t_ends = sw_score_batch(qb, tb, params)
        # ---- per-contig winner processing (host) --------------------------
        for wk, (start, count) in zip(active, spans):
            sl = slice(start, start + count)
            # first index of the max score — the same winner the stable
            # argsort-descending picked (earliest-window tie-break).
            # Pass-1 placement considers REGION windows only (reference
            # two-pass parity); the genome windows in this round's batch
            # exist for the uniqueness margin below.
            place_n = count if wk.use_genome else wk.n_region_windows
            best = int(np.argmax(scores[sl][:place_n]))
            if int(scores[sl][best]) < min_seg_score:
                if genome is not None and not wk.use_genome:
                    wk.use_genome = True
                    if count > place_n:
                        # margins mode already scored the genome windows
                        # in THIS batch — the pass-2 winner is the same
                        # one the retry round would re-gather and
                        # re-score, so select it now and save a lockstep
                        # round (one device launch)
                        best = int(np.argmax(scores[sl]))
                        if int(scores[sl][best]) >= min_seg_score:
                            pass  # fall through to _process_winner
                        else:
                            wk.done = True
                            continue
                    else:
                        continue  # retry genome-wide next round
                else:
                    wk.done = True
                    continue
            # runner-up among windows genomically DISJOINT from the winner
            # (either strand): the round's free placement-uniqueness
            # margin (AlignSegment.second_score). Windows overlapping the
            # winner are alternative placements of the SAME locus, not
            # competitors.
            bw = wk.windows[best]
            b_off = wk.region.start if best < wk.n_region_windows else 0
            bc = bw.chrom or wk.region.chrom
            bs, be = b_off + bw.t_start, b_off + bw.t_end
            # a margin is only meaningful when genome-wide competitors
            # were in this round's batch (or no genome index exists)
            margins_valid = (genome is None or genome_margins
                             or wk.use_genome)
            second = 0 if margins_valid else -1
            L_q = len(wk.masked)
            b_qlo, b_qhi = _min_fwd_span(
                int(q_ends[sl][best]), int(scores[sl][best]),
                bw.strand, L_q, params.match,
            )
            for j in range(count if margins_valid else 0):
                if j == best:
                    continue
                w2 = wk.windows[j]
                off2 = wk.region.start if j < wk.n_region_windows else 0
                c2 = w2.chrom or wk.region.chrom
                if c2 == bc and off2 + w2.t_start < be and off2 + w2.t_end > bs:
                    continue
                sc = int(scores[sl][j])
                if sc <= second:
                    continue
                # sibling-segment exclusion (ADVICE r4 #1): on a round-1
                # multi-locus contig (trl/dup/inv) the OTHER segment's
                # true locus is genomically disjoint from the winner but
                # aligns a DIFFERENT query interval — it is not a
                # competitor for the winner's bases. Require the
                # minimal query spans (>= score/match bases ending at the
                # device best cell, in forward-contig coords) to overlap.
                j_qlo, j_qhi = _min_fwd_span(
                    int(q_ends[sl][j]), sc, w2.strand, L_q, params.match,
                )
                if j_qhi <= b_qlo or j_qlo >= b_qhi:
                    continue
                second = sc
            _process_winner(
                wk, best, int(scores[sl][best]),
                int(q_ends[sl][best]), int(t_ends[sl][best]),
                params, min_seg_len, min_identity, min_seg_score,
                full_hit_cov, max_q_gap, second_score=second,
            )
            # pass 2 and later consult the genome (reference gfClient leg)
            wk.use_genome = genome is not None
    out = []
    for wk, (codes0, _region) in zip(works, contigs):
        wk.segments.sort(key=lambda s: (s.q_start, s.q_end))
        _refine_boundaries(
            np.asarray(codes0, dtype=np.int8), wk.segments, wk.region,
            genome, params,
        )
        out.append(wk.segments)
    return out


_REFINE_W = 12  # max junction slide, bases


def _refine_ref(region: RegionRef, genome, chrom: str, a: int, b: int):
    """Reference codes for [a, b) on chrom, or None when unavailable —
    served from the region cache when in range, else the genome index."""
    if a < 0 or b <= a:
        return None
    if (
        chrom == region.chrom
        and a >= region.start
        and b <= region.start + len(region.codes)
    ):
        return region.codes[a - region.start : b - region.start]
    if genome is not None:
        try:
            if b <= genome.length(chrom):
                got = genome.fetch_codes(chrom, a, b)
                if len(got) == b - a:
                    return got
        except KeyError:
            return None
    return None


def _eq_profile(
    codes0: np.ndarray, seg: AlignSegment, side: str, b0: int,
    lo: int, hi: int, region: RegionRef, genome,
) -> Optional[np.ndarray]:
    """For forward-contig positions j in [lo, hi): does contig[j] match the
    reference base it would pair with under a GAPLESS extension/shrink of
    ``seg`` across the junction at b0?  side='right' = the junction is at
    seg.q_end (b0 == seg.q_end); side='left' = at seg.q_start."""
    n = hi - lo
    j = np.arange(lo, hi)
    if seg.strand == "+":
        # forward j pairs with t = anchor + (j - b0)
        anchor = seg.t_end if side == "right" else seg.t_start
        t_lo, t_hi = anchor + (lo - b0), anchor + (hi - b0)
        ref = _refine_ref(region, genome, seg.chrom, t_lo, t_hi)
        if ref is None:
            return None
        want = ref
    else:
        # '-' strand: forward j pairs with t = anchor - 1 - (j - b0),
        # complemented (anchor = t_start at the q_end side, t_end at q_start)
        anchor = seg.t_start if side == "right" else seg.t_end
        t_lo, t_hi = anchor - (hi - b0), anchor - (lo - b0)
        ref = _refine_ref(region, genome, seg.chrom, t_lo, t_hi)
        if ref is None:
            return None
        want = 3 - ref[::-1]  # reverse-complement onto forward-j order
    q = codes0[lo:hi]
    return (q == want) & (q < 4) & (want >= 0) & (want < 4)


def _edge_m_len(aln: Alignment, edge: str) -> int:
    op, ln = aln.ops[0] if edge == "head" else aln.ops[-1]
    return ln if op == "M" else 0


def _grow_edge(aln: Alignment, edge: str, delta: int) -> None:
    idx = 0 if edge == "head" else -1
    op, ln = aln.ops[idx]
    aln.ops[idx] = (op, ln + delta)


def _apply_boundary_move(
    seg: AlignSegment, side: str, delta: int, eq: np.ndarray,
    lo: int, b0: int, params: SWParams,
) -> None:
    """Move seg's junction-side query boundary by ``delta`` forward-contig
    bases (positive = junction moves right), updating genomic coords, the
    window-local alignment (coords + edge M run), and match/score tallies.
    The move is gapless by construction (guards checked by the caller)."""
    if delta == 0:
        return
    if side == "right":
        moved = eq[b0 - lo : b0 - lo + delta] if delta > 0 else \
            eq[b0 - lo + delta : b0 - lo]
        gain = 1 if delta > 0 else -1
        seg.q_end += delta
        edge = "tail" if seg.strand == "+" else "head"
        if seg.strand == "+":
            seg.t_end += delta
            seg.alignment.q_end += delta
            seg.alignment.t_end += delta
        else:
            seg.t_start -= delta
            seg.alignment.q_start -= delta
            seg.alignment.t_start -= delta
    else:
        moved = eq[b0 - lo : b0 - lo + delta] if delta > 0 else \
            eq[b0 - lo + delta : b0 - lo]
        gain = -1 if delta > 0 else 1
        seg.q_start += delta
        edge = "head" if seg.strand == "+" else "tail"
        if seg.strand == "+":
            seg.t_start += delta
            seg.alignment.q_start += delta
            seg.alignment.t_start += delta
        else:
            seg.t_end -= delta
            seg.alignment.q_end -= delta
            seg.alignment.t_end -= delta
    m = int(np.sum(moved))
    mm = len(moved) - m
    seg.matches += gain * m
    seg.mismatches += gain * mm
    seg.score += gain * (m * params.match - mm * params.mismatch)
    seg.alignment.matches += gain * m
    seg.alignment.mismatches += gain * mm
    seg.alignment.score += gain * (m * params.match - mm * params.mismatch)
    _grow_edge(seg.alignment, edge, gain * len(moved))


def _run_eq(
    codes0: np.ndarray, seg: AlignSegment, side: str, m: int,
    region: RegionRef, genome,
) -> Optional[np.ndarray]:
    """eq per base of the junction-side terminal M run (length m) of
    ``seg``'s alignment: side='right' = the run ending at seg.q_end,
    side='left' = the run starting at seg.q_start (forward coords)."""
    if side == "right":
        q_lo, q_hi = seg.q_end - m, seg.q_end
        t_lo, t_hi = (
            (seg.t_end - m, seg.t_end) if seg.strand == "+"
            else (seg.t_start, seg.t_start + m)
        )
    else:
        q_lo, q_hi = seg.q_start, seg.q_start + m
        t_lo, t_hi = (
            (seg.t_start, seg.t_start + m) if seg.strand == "+"
            else (seg.t_end - m, seg.t_end)
        )
    ref = _refine_ref(region, genome, seg.chrom, t_lo, t_hi)
    if ref is None:
        return None
    want = ref if seg.strand == "+" else (3 - ref[::-1])
    q = codes0[q_lo:q_hi]
    return (q == want) & (q < 4) & (want >= 0) & (want < 4)


def _try_pop_gap_overrun(
    codes0: np.ndarray, seg: AlignSegment, side: str, other: AlignSegment,
    region: RegionRef, genome, params: SWParams,
) -> bool:
    """Undo a junction gap-overrun: when ``seg``'s junction-side alignment
    ends [..., gap, M-run<=W], SW accepted the short run because it nets a
    couple of points past a gap — but those query bases usually belong to
    ``other`` (they continue ITS reference past the junction with full
    matches). Pop the run+gap off seg and extend other gaplessly iff total
    SW score strictly improves. Returns True if applied."""
    aln = seg.alignment
    if len(aln.ops) < 3:
        return False
    # junction-side edge in oriented alignment coords
    edge = (
        "tail" if (seg.strand == "+") == (side == "right") else "head"
    )
    if edge == "tail":
        (g_op, g_len), (m_op, m_len) = aln.ops[-2], aln.ops[-1]
    else:
        (m_op, m_len), (g_op, g_len) = aln.ops[0], aln.ops[1]
    if m_op != "M" or g_op not in ("I", "D") or m_len > _REFINE_W:
        return False
    q_freed = m_len + (g_len if g_op == "I" else 0)
    t_freed = m_len + (g_len if g_op == "D" else 0)
    # seg must keep at least one query base and its inner op stays M
    if seg.q_end - seg.q_start <= q_freed:
        return False
    # score delta of removing the run + gap from seg
    run_eq = _run_eq(codes0, seg, side, m_len, region, genome)
    if run_eq is None:
        return False
    # other's junction edge must be an M run (gapless growth target)
    o_edge = (
        ("head" if other.strand == "+" else "tail") if side == "right"
        else ("tail" if other.strand == "+" else "head")
    )
    if _edge_m_len(other.alignment, o_edge) == 0:
        return False
    m_hit = int(np.sum(run_eq))
    m_miss = m_len - m_hit
    d_seg = (
        -(m_hit * params.match - m_miss * params.mismatch)
        + params.gap_open + g_len * params.gap_extend
    )
    # other absorbs the freed FORWARD-contig query bases gaplessly
    if side == "right":
        # other extends left from its q_start by q_freed
        b0o = other.q_start
        lo, hi = b0o - q_freed, b0o
        eq_o = _eq_profile(codes0, other, "left", b0o, lo, hi, region, genome)
        delta_o, o_side = -q_freed, "left"
    else:
        b0o = other.q_end
        lo, hi = b0o, b0o + q_freed
        eq_o = _eq_profile(codes0, other, "right", b0o, lo, hi, region, genome)
        delta_o, o_side = q_freed, "right"
    if eq_o is None:
        return False
    o_hit = int(np.sum(eq_o))
    d_other = o_hit * params.match - (q_freed - o_hit) * params.mismatch
    if d_seg + d_other <= 0:
        return False
    # ---- apply: pop seg's run+gap ----------------------------------------
    if edge == "tail":
        aln.ops = aln.ops[:-2]
        aln.q_end -= q_freed
        aln.t_end -= t_freed
    else:
        aln.ops = aln.ops[2:]
        aln.q_start += q_freed
        aln.t_start += t_freed
    aln.matches -= m_hit
    aln.mismatches -= m_miss
    aln.score += d_seg
    seg.matches -= m_hit
    seg.mismatches -= m_miss
    seg.score += d_seg
    if side == "right":
        seg.q_end -= q_freed
        if seg.strand == "+":
            seg.t_end -= t_freed
        else:
            seg.t_start += t_freed
    else:
        seg.q_start += q_freed
        if seg.strand == "+":
            seg.t_start += t_freed
        else:
            seg.t_end -= t_freed
    # ---- extend other over the freed bases (gapless) ---------------------
    _apply_boundary_move(
        other, o_side, delta_o, eq_o, lo,
        b0o, params,
    )
    return True


def _refine_boundaries(
    codes0: np.ndarray,
    segments: List[AlignSegment],
    region: RegionRef,
    genome,
    params: SWParams,
) -> None:
    """Slide each abutting split-junction boundary to the gapless split
    that maximizes total reference matches (ties -> smallest move).

    Why: masked requery accepts segments greedily, so near-homologous
    junction context lets the FIRST-found piece overclaim a few query
    bases (its max-score core extends through 2-of-3-matching bases) and
    the mask then truncates the other piece — a systematic few-bp
    breakpoint bias on tandem-dup/deletion/inversion junctions that the
    round-3 noisy-read sweep exposed (ACCURACY_r03: dup recall 69%% before
    this pass). The reference's blat picks among overlapping PSL rows and
    has the same ambiguity; left-normalizing to the max-match split is our
    pinned parity rule."""
    for s1, s2 in zip(segments, segments[1:]):
        if s2.q_start != s1.q_end:
            continue  # gap junction (inserted bases) — nothing to slide
        # Pop-then-slide to a FIXED POINT: a slide can shrink a junction
        # M run below _REFINE_W and thereby expose a gap-overrun the pop
        # refused before the slide (seed-116 shape: [96M 7I 20M][69M] —
        # pop sees m_len 20 > W, the slide turns it into [.. 7I 8M][81M],
        # and only a SECOND pop recovers the true junction). Each pop
        # strictly raises total SW score and each slide strictly raises
        # total matches, so 4 rounds is far past convergence.
        for _round in range(4):
            changed = False
            # undo small gap-overruns on either side of the junction
            for _ in range(2):
                popped = _try_pop_gap_overrun(
                    codes0, s1, "right", s2, region, genome, params
                ) | _try_pop_gap_overrun(
                    codes0, s2, "left", s1, region, genome, params
                )
                changed |= popped
                if not popped:
                    break
            b0 = s1.q_end
            # gapless guards: shrinking an alignment must stay inside its
            # junction-side M run; growth is always gapless
            s1_edge = "tail" if s1.strand == "+" else "head"
            s2_edge = "head" if s2.strand == "+" else "tail"
            max_left = min(
                _REFINE_W, b0 - (s1.q_start + 1),
                _edge_m_len(s1.alignment, s1_edge) - 1,
            )
            max_right = min(
                _REFINE_W, (s2.q_end - 1) - b0,
                _edge_m_len(s2.alignment, s2_edge) - 1,
            )
            if max_left < 0 or max_right < 0 or max_left + max_right == 0:
                break
            lo, hi = b0 - max_left, b0 + max_right
            eq1 = _eq_profile(codes0, s1, "right", b0, lo, hi, region, genome)
            eq2 = _eq_profile(codes0, s2, "left", b0, lo, hi, region, genome)
            if eq1 is None or eq2 is None:
                break
            # total(b) = matches of [lo,b) on s1 + [b,hi) on s2, b in [lo,hi]
            c1 = np.concatenate([[0], np.cumsum(eq1)])
            c2 = np.concatenate([[0], np.cumsum(eq2)])
            totals = c1 + (c2[-1] - c2)
            base = totals[b0 - lo]
            best_b, best_total = b0, base
            for b in range(lo, hi + 1):
                t = totals[b - lo]
                if t > best_total or (
                    t == best_total and abs(b - b0) < abs(best_b - b0)
                ):
                    best_b, best_total = b, t
            delta = best_b - b0
            if delta != 0:
                _apply_boundary_move(s1, "right", delta, eq1, lo, b0, params)
                _apply_boundary_move(s2, "left", delta, eq2, lo, b0, params)
                changed = True
            if not changed:
                break


def realign_contig(
    contig_codes: np.ndarray,
    region: RegionRef,
    genome: Optional[GenomeIndex] = None,
    params: SWParams = SWParams(),
    **kw,
) -> List[AlignSegment]:
    """Single-contig convenience wrapper over :func:`realign_contigs`
    (one shared implementation — see there for the algorithm)."""
    return realign_contigs(
        [(contig_codes, region)], genome=genome, params=params, **kw
    )[0]
