#!/usr/bin/env python
"""Genome-scale END-TO-END pipeline check: the full Runner against a
synthetic >=100 Mbp reference with planted SVs.

tools/bench_genome_index.py proves the gfServer-replacement INDEX at
3.1 Gbp; this proves the whole pipeline around it at genome scale —
FASTA indexing, the runner's streaming GenomeIndex build, the (sparse,
uncompressed) index cache artifact save + warm reload, genome-pass
realignment against a real-size seed table, and the planted calls
coming out right. Prints one JSON line; GENOME_E2E_r02.json records it.

Usage: python tools/bench_genome_e2e.py [total_bp]   (default 100e6)

At the full 3.1 Gbp scale this additionally reports the index-artifact
save/load seconds (timed inside Runner.setup via wrappers) and the
process peak RSS — the runner-level numbers GENOME_INDEX_rNN.json's
index-only bench cannot see.

Runs on CPU by design: this is a host/IO-integration artifact (the
device tiers it launches are the same panel tiers bench_panel.py times
on the real chip).
"""

import json
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from breakmer_tpu.align.index import GenomeIndex  # noqa: E402
from breakmer_tpu.config import Config  # noqa: E402
from breakmer_tpu.runner import Runner  # noqa: E402

sys.path.insert(0, str(REPO / "tests"))
from fixtures import Haplotype, NovelBlock, RefBlock, SamBuilder  # noqa: E402

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# timing wrappers so the artifact save/load inside Runner.setup is
# measured exactly (not inferred from setup_cold/warm deltas)
_IO_TIMES = {"save_s": None, "load_s": None, "artifact_mb": None}
_orig_save, _orig_load = GenomeIndex.save, GenomeIndex.load


def _timed_save(self, path):
    t0 = time.time()
    out = _orig_save(self, path)
    _IO_TIMES["save_s"] = time.time() - t0
    _IO_TIMES["artifact_mb"] = Path(path).stat().st_size / 1e6
    return out


def _timed_load(cls, path):
    t0 = time.time()
    out = _orig_load.__func__(cls, path)
    _IO_TIMES["load_s"] = time.time() - t0
    return out


GenomeIndex.save = _timed_save
GenomeIndex.load = classmethod(_timed_load)


def _vm_rss_mb() -> float:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return 0.0


def rand_chrom(seed: int, n: int) -> str:
    # uint8 draws: the default int64 would transiently cost 8 bytes/bp
    # (25 GB at 3.1 Gbp)
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, n, dtype=np.uint8)].tobytes().decode()


def main() -> None:
    total = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
    if total < 85_000_000:
        sys.exit("total_bp must be >= 8.5e7: targets sit at fixed "
                 "chr1:10M..40M offsets (chr1 is total/2)")
    work = Path(tempfile.mkdtemp(prefix="breakmer_genome_e2e_"))
    try:
        # 3 chroms, hg-like ratio; targets live on chr1
        n1, n2, n3 = int(total * 0.5), int(total * 0.3), int(total * 0.2)
        genome = {
            "chr1": rand_chrom(11, n1),
            "chr2": rand_chrom(22, n2),
            "chr3": rand_chrom(33, n3),
        }
        t0 = time.time()
        fa = work / "genome.fa"
        with open(fa, "w") as fh:
            for name, seq in genome.items():
                fh.write(f">{name}\n")
                for i in range(0, len(seq), 10_000_000):
                    fh.write(seq[i : i + 10_000_000] + "\n")
        write_s = time.time() - t0

        # 4 targets deep inside chr1; plant an insertion, a deletion and
        # a chr1->chr3 translocation (the genome realignment pass must
        # place the partner segment through the full-genome seed index)
        targets = [
            ("chr1", 10_000_000, 10_001_200, "G_INS"),
            ("chr1", 20_000_000, 20_001_200, "G_DEL"),
            ("chr1", 30_000_000, 30_001_200, "G_TRL"),
            ("chr1", 40_000_000, 40_001_200, "G_REF"),
        ]
        with open(work / "targets.bed", "w") as fh:
            for c, s, e, g in targets:
                fh.write(f"{c}\t{s}\t{e}\t{g}\n")
        sam = SamBuilder(genome)
        INS = "TTGACCATGGATCCGGTACAT"
        sam.add_haplotype_reads(Haplotype(genome, [
            RefBlock("chr1", 10_000_000, 10_000_600), NovelBlock(INS),
            RefBlock("chr1", 10_000_600, 10_001_200),
        ]), 180, 820, prefix="ins")
        sam.add_haplotype_reads(Haplotype(genome, [
            RefBlock("chr1", 20_000_000, 20_000_500),
            RefBlock("chr1", 20_000_560, 20_001_200),
        ]), 180, 1000, prefix="dele")
        sam.add_haplotype_reads(Haplotype(genome, [
            RefBlock("chr1", 30_000_000, 30_000_600),
            RefBlock("chr3", 5_000_000, 5_000_500),
        ]), 180, 820, prefix="trl")
        sam.add_discordant_pairs("chr1", 30_000_600, "chr3", 5_000_000, n=5)
        for c, s, e, g in targets:
            sam.add_background_pairs(c, s - 200, e + 200, prefix=f"bg{g}")
        sam.write(work / "sample.sam")
        # drop the in-process fixture strings (~1 byte/bp each in genome
        # and SamBuilder) so the runner-phase RSS numbers are the
        # runner's own footprint, not the generator's
        import gc

        del sam, genome
        gc.collect()
        rss_fixture_mb = _vm_rss_mb()

        base = dict(
            analysis_name="genome_e2e",
            targets_bed_file=str(work / "targets.bed"),
            reference_fasta=str(fa),
            reference_data_dir=str(work / "refdata"),
            sample_bam_file=str(work / "sample.sam"),
            indel_sr_thresh=2, rearr_sr_thresh=2, trl_sr_thresh=2,
            batch_regions=True,
        )
        t1 = time.time()
        r1 = Runner(Config(analysis_dir=str(work / "a1"), **base))
        r1.setup()
        setup_cold_s = time.time() - t1
        t2 = time.time()
        events = r1.run()
        run_s = time.time() - t2
        idx_nbytes = r1.genome.nbytes if r1.genome is not None else 0
        rss_cold_mb = _vm_rss_mb()
        del r1
        gc.collect()

        # warm pass: the cached index artifact must reload and reproduce
        t3 = time.time()
        r2 = Runner(Config(analysis_dir=str(work / "a2"), **base))
        r2.setup()
        setup_warm_s = time.time() - t3
        events2 = r2.run()
        rss_warm_mb = _vm_rss_mb()

        by_gene = {e.genes: e for e in events}
        ok_ins = by_gene.get("G_INS") is not None and by_gene["G_INS"].sv_type == "indel" \
            and by_gene["G_INS"].size == len(INS)
        ok_del = by_gene.get("G_DEL") is not None and by_gene["G_DEL"].sv_subtype in ("D", "del")
        ok_trl = by_gene.get("G_TRL") is not None and by_gene["G_TRL"].sv_type == "trl"
        same = len(events) == len(events2) and all(
            a.genes == b.genes and a.sv_type == b.sv_type
            and a.breakpoints == b.breakpoints
            for a, b in zip(events, events2)
        )
        peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        print(json.dumps({
            "metric": "genome_e2e",
            "total_bp": total,
            "calls": len(events),
            "ins_called": bool(ok_ins),
            "del_called": bool(ok_del),
            "trl_called": bool(ok_trl),
            "warm_equals_cold": bool(same),
            "fasta_write_s": round(write_s, 1),
            "setup_cold_s": round(setup_cold_s, 1),
            "setup_warm_s": round(setup_warm_s, 1),
            "run_s": round(run_s, 1),
            "index_resident_mb": round(idx_nbytes / 1e6, 1),
            "index_save_s": round(_IO_TIMES["save_s"], 1)
            if _IO_TIMES["save_s"] is not None else None,
            "index_load_s": round(_IO_TIMES["load_s"], 1)
            if _IO_TIMES["load_s"] is not None else None,
            "index_artifact_mb": round(_IO_TIMES["artifact_mb"], 1)
            if _IO_TIMES["artifact_mb"] is not None else None,
            "rss_fixture_mb": round(rss_fixture_mb, 1),
            "rss_after_cold_run_mb": round(rss_cold_mb, 1),
            "rss_after_warm_run_mb": round(rss_warm_mb, 1),
            "peak_rss_mb": round(peak_rss_mb, 1),
        }))
        if not (ok_ins and ok_del and ok_trl and same):
            sys.exit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
