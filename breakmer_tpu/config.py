"""Configuration system.

Re-designs the reference's params class (reference: breakmer.py
``class params``, ~lines 120-250 — key=value config file merged with CLI
options) as a single dataclass, JSON/key=value loadable. Knob names follow
the reference where known; defaults marked "reconstructed" were recovered
from training knowledge of BreaKmer's README/paper and are configurable so
parity runs can pin them (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Optional


@dataclasses.dataclass
class Config:
    # --- inputs -----------------------------------------------------------
    analysis_name: str = "breakmer_tpu"
    analysis_dir: str = "analysis"
    targets_bed_file: Optional[str] = None
    reference_fasta: Optional[str] = None
    reference_data_dir: Optional[str] = None  # cache of packed refs + indexes
    sample_bam_file: Optional[str] = None     # BAM or SAM or FASTQ sidecar
    normal_bam_file: Optional[str] = None
    repeat_mask_file: Optional[str] = None
    other_regions_file: Optional[str] = None
    gene_list: Optional[str] = None           # restrict to these targets
    filter_list: Optional[str] = None         # BED of intervals whose calls
                                              # are suppressed (user filter)
    cutadapt_config_file: Optional[str] = None  # reference-style nested
                                              # cutadapt args file; parsed
                                              # into the native trim knobs
                                              # (explicit keys win)

    # --- k-mer engine (reference: utils.py run_jellyfish + target.compare_kmers)
    kmer_size: int = 15            # reference default k=15
    min_kmer_count: int = 2        # drop count-1 sample kmers (reconstructed)
    # contig-level germline recheck vs the matched normal (r3): the raw-read
    # k-mer subtraction is defeated when two sample reads share one
    # sequencing error (a count-2 error k-mer absent from the normal recruits
    # the germline junction reads); the assembled consensus is the clean
    # germline sequence, so recheck ITS novel k-mers against the normal.
    # An event is germline when >= min novel k-mers are normal-present AND
    # they are >= frac of all novel k-mers (the frac guard keeps somatic
    # contigs that merely overlap a germline SNP).
    germline_kmer_min: int = 3
    germline_kmer_frac: float = 0.5
    # edit-tolerant fallback when k-mer evidence is inconclusive (the leaked
    # contig's consensus carries the error-sharing reads' other errors): a
    # normal read aligning >= window-slack bases of the junction window at
    # >= this identity proves the normal carries the junction adjacency
    germline_sw_identity: float = 0.85
    germline_sw_slack: int = 4

    # --- read extraction (reference: target.extract_bam_reads) ------------
    min_clip_len: int = 3          # min soft-clip length to keep (reconstructed)
    adapter_3p: Optional[str] = None  # cutadapt -a equivalent
    adapter_5p: Optional[str] = None  # cutadapt -g equivalent
    adapter_error_rate: float = 0.1   # cutadapt -e equivalent
    trim_qual: int = 3             # cutadapt -q equivalent
    min_read_len: int = 25         # drop reads shorter than this after trim
    min_sv_reads: int = 2          # skip region if fewer SV reads survive
    min_clip_qual: int = 3         # min avg base quality in the clip (reconstructed)
    clip_coverage: bool = False    # count soft-clipped bases into breakpoint
                                   # depth (reference pileup counts aligned
                                   # bases only; opt-in quality extension —
                                   # clipped-side breakpoints otherwise read
                                   # artificially low)
    insert_size_thresh: int = 1000  # |tlen| beyond which a pair is discordant
    region_buffer: int = 200       # bp added on each side of a target region

    # --- assembly (reference: sv_assembly.py init_assembly) ---------------
    min_contig_reads: int = 2      # min supporting reads to keep a contig
    min_contig_len: int = 20       # contigs shorter than this are dropped
    olc_merge: bool = True         # OLC-merge overlapping contigs after
                                   # assembly (reference: olc.py contig
                                   # consolidation) — one junction split
                                   # across two contigs becomes one call
    olc_min_overlap: int = 20      # min suffix/prefix overlap to fuse
    contig_extension: bool = True  # extend contigs through ALL region
                                   # reads (clean-mapped included) by
                                   # exact-anchor consensus voting: inside
                                   # tandem arrays the SV reads alone end
                                   # before unique flank and the call is
                                   # absorbed (assemble/extend.py; r5
                                   # TANDEM_FLOOR oracle: 32/45 tandem
                                   # misses were exactly this). Beyond
                                   # reference behavior — off restores
                                   # sv-read-only assembly
    extension_anchor_k: int = 31   # terminal anchor length (<= 31)
    extension_max_grow: int = 400  # growth cap per contig side, bp

    # --- realignment (replaces BLAT; align/ package) ----------------------
    seed_kmer_size: int = 11       # BLAT DNA default tile size is 11
    match_score: int = 2
    mismatch_pen: int = 3          # subtracted
    gap_open_pen: int = 5          # first gapped base costs open+extend
    gap_extend_pen: int = 1
    min_identity: float = 0.90     # min percent identity for a usable alignment
    full_hit_cov: float = 0.95     # query coverage => "single alignment" path
    max_segments: int = 3          # greedy disjoint-segment selection depth
                                   # (reference parity default; raise for
                                   # chained rearrangements with 4+ contig
                                   # segments — VERDICT r1 missing #6)

    # --- SV calling thresholds (reference: sv_caller.py filter stack) -----
    indel_size: int = 15           # min indel size to report (reference default)
    indel_sr_thresh: int = 5       # split-read support for indels (reconstructed)
    rearr_sr_thresh: int = 2       # split-read support for rearrangements
    trl_sr_thresh: int = 2         # split-read support for translocations
    rearr_min_seg_len: int = 30    # min segment length for rearrangements
    trl_min_seg_len: int = 25      # min segment length for translocations
    min_disc_reads: int = 2        # discordant-pair support for translocations
    min_junction_overlap: int = 5  # bp a split read must span past a junction
    disc_pair_window: int = 1000   # bp window for matching disc mates to breakpoints
    global_disc_support: bool = False  # count disc-pair support from a run-level
    #                                map over the WHOLE sample (pairs anchored
    #                                outside the region window contribute; the
    #                                reference's per-target dict misses them —
    #                                SURVEY.md §2 #6/#13). Global counts are
    #                                per-PAIR (qname-deduped); the default
    #                                per-region map counts per RECORD (parity)
    max_repeat_frac: float = 0.75  # reject segment if rmask overlap above this
    repeat_uniq_rescue: bool = True  # a repeat-masked segment still passes
    #                                when its realignment was genomically
    #                                unambiguous: the best competing window
    #                                at a DIFFERENT locus scored <=
    #                                repeat_uniq_ratio x the winner
    #                                (AlignSegment.second_score). Repeat
    #                                ANNOTATION alone is not evidence of
    #                                mismapping when no competing placement
    #                                exists; without this, every junction
    #                                inside a diverged repeat copy is
    #                                uncallable (r4 repeat-genome sweeps).
    repeat_uniq_ratio: float = 0.9
    min_complexity: float = 0.25   # low-complexity contig filter threshold
    dedup_identical_events: bool = True  # collapse per-contig events that
    #                                are identical in call content (two
    #                                het-haplotype contigs of one junction
    #                                that exact-overlap OLC cannot merge);
    #                                survivor keeps max support counts,
    #                                duplicates get filter_reason
    #                                'duplicate_call' (observability)
    keep_repeat_regions: bool = False
    keep_intron_vars: bool = False

    build_genome_index: bool = True  # in-memory genome seed index (gfServer analog)
    shard_genome_index: bool = False  # shard the seed table across the device
                                      # mesh with collective lookups (v2 of the
                                      # gfServer replacement; needs >1 device —
                                      # silently stays replicated otherwise)
    device: str = "auto"           # auto | cpu | gpu (see breakmer_tpu.device)

    # --- device / parallel ------------------------------------------------
    nprocs: int = 1                # reference -p; host worker threads over
    #                                the batched path's host stages (runner)
    batch_regions: bool = False    # pack regions into one device kmer launch
    kmer_regions_per_batch: int = 32  # regions per packed kmer launch:
    #                                fewer, larger launches (a tier-packed
    #                                8-region upload is ~0.15 MB; padded-
    #                                region FLOPs are negligible at these
    #                                shapes). Rounded to a mesh-axis multiple
    #                                when sharded.
    preload_alignments: bool = True  # parse the alignment file once, filter
                                     # per region in memory (False = rescan)
    preload_max_mb: Optional[float] = 4096  # bounded-memory guard: a .bam
    #                                bigger than this on disk (compressed;
    #                                BGZF typically inflates 2-4x) with a
    #                                sidecar .bai/.csi is served by indexed
    #                                per-region seeks instead of a whole-file
    #                                inflate, regardless of
    #                                preload_alignments. None disables the
    #                                guard. (VERDICT r2 weak #4: a 50 GB
    #                                production BAM must not be inflated
    #                                wholesale.)
    multihost: bool = False        # partition targets across jax processes
    coordinator_address: Optional[str] = None  # jax.distributed coordinator
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    contig_pad_tiers: tuple = (128, 256, 512, 1024)  # bucketed pad lengths
    window_pad_tiers: tuple = (256, 512, 1024, 2048)
    batch_pad: int = 8             # pad (contig, window) batches to multiple

    # --- misc -------------------------------------------------------------
    log_level: str = "INFO"
    keep_intermediates: bool = False

    REQUIRED_FOR_RUN = (
        "targets_bed_file", "reference_fasta", "sample_bam_file",
    )

    def validate(self) -> None:
        """Fail fast with a clear message before any work starts."""
        from pathlib import Path

        missing = [k for k in self.REQUIRED_FOR_RUN if not getattr(self, k)]
        if missing:
            raise ValueError(
                f"config missing required settings: {', '.join(missing)}"
            )
        for key in (
            "targets_bed_file", "reference_fasta", "sample_bam_file",
            "normal_bam_file", "repeat_mask_file", "other_regions_file",
            "gene_list", "filter_list", "cutadapt_config_file",
        ):
            val = getattr(self, key)
            if val and not Path(val).exists():
                raise FileNotFoundError(f"config {key}: no such file: {val}")
        if self.kmer_size < self.seed_kmer_size:
            raise ValueError(
                f"kmer_size ({self.kmer_size}) must be >= seed_kmer_size "
                f"({self.seed_kmer_size})"
            )

    def get_param(self, key: str, default=None):
        """Reference-parity accessor (breakmer.py params.get_param)."""
        return getattr(self, key, default)

    def set_param(self, key: str, value) -> None:
        setattr(self, key, value)

    @classmethod
    def from_file(cls, path: str | Path, **overrides) -> "Config":
        """Load from a JSON file or a reference-style ``key=value`` file."""
        path = Path(path)
        text = path.read_text()
        data: dict = {}
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            for raw in text.splitlines():
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, val = line.partition("=")
                data[key.strip()] = val.strip()
        data.update(overrides)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        if data.get("cutadapt_config_file"):
            # reference parity (breakmer.py params: cutadapt_config_file is
            # a nested config of raw cutadapt args): map the supported
            # flags onto the native trim knobs; keys set explicitly in the
            # main config override the nested file
            ca_path = Path(data["cutadapt_config_file"])
            if not ca_path.exists():
                # same friendly error validate() raises, but reachable on
                # this path (parsing happens before validate runs)
                raise FileNotFoundError(
                    f"config cutadapt_config_file: no such file: {ca_path}"
                )
            mapped = _parse_cutadapt_args(ca_path.read_text())
            data = {**{k: v for k, v in mapped.items() if k not in data}, **data}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, val in data.items():
            if key not in fields:
                continue  # tolerate unknown keys like the reference parser
            ftype = fields[key].type
            if isinstance(val, str):
                if ftype == "int":
                    val = int(val)
                elif ftype == "float":
                    val = float(val)
                elif ftype == "bool":
                    val = val.lower() in ("1", "true", "yes", "on")
            kwargs[key] = val
        return cls(**kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)


def _qual_cutoff(val: str) -> int:
    """cutadapt accepts '-q 20' and '-q 5,20' (5' cutoff, 3' cutoff); the
    native trimmer has one quality knob, so keep the 3' (last) value."""
    return int(val.split(",")[-1])


# cutadapt flag -> (Config knob, parser); the subset the reference's
# trimming stage exercises (SURVEY.md §2 #8: adapter/quality trim +
# min-length recheck). Unknown flags are ignored like unknown config keys.
_CUTADAPT_FLAGS = {
    "-a": ("adapter_3p", str), "--adapter": ("adapter_3p", str),
    "-g": ("adapter_5p", str), "--front": ("adapter_5p", str),
    "-q": ("trim_qual", _qual_cutoff), "--quality-cutoff": ("trim_qual", _qual_cutoff),
    "-m": ("min_read_len", int), "--minimum-length": ("min_read_len", int),
    "-e": ("adapter_error_rate", float), "--error-rate": ("adapter_error_rate", float),
}

_CUTADAPT_LONG_EQ = re.compile(r"^(--[\w-]+)=(.*)$")


def _parse_cutadapt_args(text: str) -> dict:
    """Parse a cutadapt-style args file ('-a SEQ -q 20 ...', '#' comments,
    '--flag=value' also accepted) into Config knob values. '=' is only a
    separator after a '--flag' token — adapter values containing '='
    (linked/parameterized syntax like 'ADAPTER;e=0.1') pass through
    intact. A repeated adapter flag is rejected loudly: cutadapt would
    search all of them, the native trimmer holds one per side."""
    tokens: list = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        for tok in line.split():
            m = _CUTADAPT_LONG_EQ.match(tok)
            if m:
                tokens.extend(m.groups())
            else:
                tokens.append(tok)
    out: dict = {}
    i = 0
    while i < len(tokens):
        spec = _CUTADAPT_FLAGS.get(tokens[i])
        if spec and i + 1 < len(tokens):
            knob, conv = spec
            if knob in ("adapter_3p", "adapter_5p") and knob in out:
                raise ValueError(
                    f"cutadapt_config_file: repeated adapter flag {tokens[i]} — "
                    "the native trimmer supports one adapter per side "
                    "(one -a/--adapter and one -g/--front)"
                )
            try:
                out[knob] = conv(tokens[i + 1])
            except ValueError as e:
                raise ValueError(
                    f"cutadapt_config_file: bad value for {tokens[i]}: "
                    f"{tokens[i + 1]!r}"
                ) from e
            i += 2
        else:
            i += 1
    return out
