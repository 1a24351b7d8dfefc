#!/usr/bin/env python
"""Bounded-memory ingest proof at production BAM scale (VERDICT r2 next
#6): build a deep-coverage synthetic BAM whose UNCOMPRESSED body is
>= 1 GB (+ sidecar .bai), then run the same panel twice in fresh child
processes —

  indexed : preload_max_mb below the file size -> the runner auto-selects
            BamIndexedReader per-region seeks; peak RSS must stay far
            below the inflated file size
  preload : guard disabled -> whole-file inflate + native columnar decode
            (the fast path for panel-sized BAMs)

— and record both peak RSS numbers plus call identity in INGEST_r03.json.

Runs on CPU (host/IO artifact). Usage:
  python tools/bench_bounded_ingest.py [uncompressed_gb]   (default 1.2)
  python tools/bench_bounded_ingest.py --child <mode> <workdir>  (internal)
"""

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

READ_LEN = 250
CHROM_LEN = 2_000_000


def _peak_rss_mb() -> float:
    """VmHWM, NOT resource.ru_maxrss: Linux preserves ru_maxrss across
    execve, so a subprocess forked from a fat parent inherits the
    parent's peak and reports it as its own. VmHWM resets on exec."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmHWM:"):
            return int(line.split()[1]) / 1024
    return 0.0


def _child(mode: str, work: Path) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from breakmer_tpu.config import Config
    from breakmer_tpu.runner import Runner

    bam = work / "deep.bam"
    size_mb = bam.stat().st_size / 2**20
    cfg = Config(
        analysis_name="ingest",
        analysis_dir=str(work / f"analysis_{mode}"),
        targets_bed_file=str(work / "targets.bed"),
        reference_fasta=str(work / "genome.fa"),
        reference_data_dir=str(work / f"refdata_{mode}"),
        sample_bam_file=str(bam),
        kmer_size=15,
        indel_sr_thresh=2,
        rearr_sr_thresh=2,
        # indexed: threshold under the on-disk size -> auto-switch;
        # preload: guard off -> whole-file inflate
        preload_max_mb=(size_mb / 2) if mode == "indexed" else None,
    )
    r = Runner(cfg)
    r.setup()
    t0 = time.time()
    events = r.run()
    run_s = time.time() - t0
    if mode == "indexed":
        assert r._preload_effective() is False, "guard did not trip"
        assert r._sample_records is None and r._native_cols is None
    else:
        assert r._preload_effective() is True
    print(json.dumps({
        "mode": mode,
        "calls": [
            [e.genes, e.sv_type, e.sv_subtype, e.breakpoints] for e in events
        ],
        "run_s": round(run_s, 1),
        "peak_rss_mb": round(_peak_rss_mb(), 1),
    }))


def _build_fixture(work: Path, target_gb: float) -> dict:
    """Deep-coverage BAM: SV reads from the noisy fixture builder over two
    target genes, plus bulk perfect-match background reads tiled over the
    chromosome until the uncompressed BAM body crosses target_gb."""
    from breakmer_tpu.io.bam import write_bam
    from breakmer_tpu.io.fasta import write_fasta
    from breakmer_tpu.io.sam import SamRecord, parse_sam_line

    sys.path.insert(0, str(REPO / "tests"))
    from fixtures import (
        ErrorModel, Haplotype, NovelBlock, RefBlock, SamBuilder, rand_seq,
    )

    genome = {"chr1": rand_seq(5, CHROM_LEN)}
    write_fasta(work / "genome.fa", genome)
    targets = [("chr1", 1_000_000, 1_000_600, "GENE1"),
               ("chr1", 1_500_000, 1_500_600, "GENE2")]
    with open(work / "targets.bed", "w") as fh:
        for c, s, e, g in targets:
            fh.write(f"{c}\t{s}\t{e}\t{g}\n")

    INS = "TTGACCATGGATCCGGTACAT"
    sam = SamBuilder(genome, error_model=ErrorModel(), error_seed=3)
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1_000_000, 1_000_300), NovelBlock(INS),
        RefBlock("chr1", 1_000_300, 1_000_600),
    ]), 180, 440, prefix="g1")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1_500_000, 1_500_300),
        RefBlock("chr1", 1_500_360, 1_500_600),
    ]), 180, 440, prefix="g2")
    for c, s, e, g in targets:
        sam.add_background_pairs(c, s - 200, e + 200, prefix=f"bg{g}")
    records = [parse_sam_line(ln) for ln in sam.lines]

    # bulk coverage: perfect-match reads, empty qual (writer emits the
    # 0xff no-qual sentinel), ~rec_bytes uncompressed each
    rec_bytes = 32 + 14 + 4 + (READ_LEN + 1) // 2 + READ_LEN
    n_bulk = int(target_gb * 1e9 / rec_bytes)
    chrom = genome["chr1"]
    cigar = [(READ_LEN, "M")]
    stride = max(1, (CHROM_LEN - READ_LEN) // max(1, n_bulk))
    bulk = []
    pos, i = 0, 0
    while i < n_bulk:
        if pos >= CHROM_LEN - READ_LEN:
            pos = (pos % 7) + 1  # next lap, phase-shifted
        bulk.append(SamRecord(
            qname=f"b{i}", flag=0, rname="chr1", pos=pos, mapq=60,
            cigar=cigar, rnext="*", pnext=-1, tlen=0,
            seq=chrom[pos : pos + READ_LEN], qual=[],
        ))
        pos += stride
        i += 1
    records.extend(bulk)
    del bulk
    records.sort(key=lambda r: r.pos)
    uncompressed_mb = (len(records) * rec_bytes) / 1e6  # close estimate
    t0 = time.time()
    write_bam(work / "deep.bam", [("chr1", CHROM_LEN)], records, index=True)
    write_s = time.time() - t0
    return {
        "records": len(records),
        "read_len": READ_LEN,
        "coverage_x": round(len(records) * READ_LEN / CHROM_LEN),
        "uncompressed_mb_est": round(uncompressed_mb),
        "bam_mb": round((work / "deep.bam").stat().st_size / 2**20, 1),
        "write_s": round(write_s, 1),
    }


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        _child(sys.argv[2], Path(sys.argv[3]))
        return
    target_gb = float(sys.argv[1]) if len(sys.argv) > 1 else 1.2
    work = Path(tempfile.mkdtemp(prefix="breakmer_ingest_"))
    try:
        fx = _build_fixture(work, target_gb)
        out = {}
        for mode in ("indexed", "preload"):
            p = subprocess.run(
                [sys.executable, __file__, "--child", mode, str(work)],
                capture_output=True, text=True, timeout=3600,
            )
            if p.returncode != 0:
                sys.exit(f"{mode} child failed:\n{p.stderr[-3000:]}")
            out[mode] = json.loads(p.stdout.strip().splitlines()[-1])
        same = out["indexed"]["calls"] == out["preload"]["calls"]
        genes = [c[0] for c in out["indexed"]["calls"]]
        print(json.dumps({
            "metric": "bounded_ingest",
            **fx,
            "calls_identical": bool(same),
            "ins_and_del_called": genes == ["GENE1", "GENE2"],
            "indexed_peak_rss_mb": out["indexed"]["peak_rss_mb"],
            "indexed_run_s": out["indexed"]["run_s"],
            "preload_peak_rss_mb": out["preload"]["peak_rss_mb"],
            "preload_run_s": out["preload"]["run_s"],
            "note": "indexed mode = preload_max_mb guard tripped "
                    "(auto-selected BamIndexedReader); RSS bound must hold "
                    "as file size grows, preload RSS scales with it",
        }))
        if not same:
            sys.exit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
