"""Smoke test of the SV-calling path on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-4 below
    python chip_smoke.py --chips 4  # four cards of one machine: the
                                    # multi-card checks only

One process drives the card through the entry points a user calls, and
exits non-zero at the first failure (nothing is caught and carried on):

1. Environment: JAX version and devices, the card's name and power limit
   (nvidia-smi, in a child that does not touch JAX), the compile cache in
   use, and the native IO library. Fails unless the platform is the GPU
   and the native library built and loaded.
2. Smith-Waterman at every realignment tier (contig tiers x window tiers)
   at B = 512: the CUDA kernel, compiled for the card, against the XLA
   scan on the card, exactly, under two scoring schemes; then the
   gpu-marked tests, in this process.
3. The device region step (k-mer subtraction + SW) on the GPU against the
   same step on the CPU device of this process, exactly.
4. The served path: ``breakmer_tpu.cli.main(["run", config])`` on a
   planted-SV panel made from ``--seed`` (200 targets of 1.2 kb, ~100x
   junction depth, a 100 Mbp genome), cold and warm. Every planted event
   must be called with its type and no SV-free target may have a call.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SMOKE_B = 512
KINDS = ("ins", "del", "dup", "inv", "trl")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# -- phase 1 -----------------------------------------------------------------

def phase_environment(n_chips: int) -> dict:
    sys.path.insert(0, str(REPO))
    from breakmer_tpu.device import configure

    platform = configure("gpu")  # raises when JAX finds no GPU
    import jax

    from breakmer_tpu import native

    devs = jax.devices()
    log(f"[1] jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].platform} ({devs[0].device_kind})")
    log(f"[1] card: {card_line()}")
    log(f"[1] compile cache: {jax.config.jax_compilation_cache_dir}")
    have_native = native.available()
    log(f"[1] native IO library loaded: {have_native}")
    if platform != "gpu" or devs[0].platform != "gpu":
        raise RuntimeError(f"platform is {devs[0].platform}, not gpu")
    if not have_native:
        raise RuntimeError("native IO library did not build and load")
    if len(devs) < n_chips:
        raise RuntimeError(f"{n_chips} cards asked for, JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# -- phase 2 -----------------------------------------------------------------

def sw_tier_batch(rng: np.random.Generator, B: int, lq: int, lt: int):
    """[B, lq] / [B, lt] int8 pairs in four quarters: random ACGT of
    ragged length (trailing pad), planted exact hits, mid-sequence N runs
    in both, and a tie-heavy 2-letter alphabet at full length."""
    q = np.full((B, lq), 4, np.int8)
    t = np.full((B, lt), 4, np.int8)
    for b in range(B):
        kind = 4 * b // B
        if kind == 3:
            q[b] = rng.integers(0, 2, lq)
            t[b] = rng.integers(0, 2, lt)
            continue
        nq = int(rng.integers(lq // 2, lq + 1))
        nt = int(rng.integers(lt // 2, lt + 1))
        q[b, :nq] = rng.integers(0, 4, nq)
        t[b, :nt] = rng.integers(0, 4, nt)
        if kind == 1:
            n = int(rng.integers(min(nq, nt) // 4, min(nq, nt) // 2 + 1))
            a = int(rng.integers(0, nq - n + 1))
            c = int(rng.integers(0, nt - n + 1))
            t[b, c:c + n] = q[b, a:a + n]
        elif kind == 2:
            n = int(rng.integers(1, 12))
            a = int(rng.integers(1, nq - n))
            c = int(rng.integers(1, nt - n))
            q[b, a:a + n] = 4
            t[b, c:c + n] = 4
    return q, t


def sw_tiers():
    from breakmer_tpu.config import Config

    cfg = Config()
    return [(lq, lt) for lq in cfg.contig_pad_tiers for lt in cfg.window_pad_tiers]


def phase_sw(seed: int) -> None:
    import jax

    from breakmer_tpu.ops.sw import SWParams, sw_score
    from breakmer_tpu.ops.sw_cuda import sw_score_cuda

    log("[2] SW agreement is exact (tolerance 0): the DP is int32 add/max/"
        "compare and the device path has no floating-point product, so TF32 "
        "does not apply")
    kernel = jax.jit(sw_score_cuda, static_argnames=("params",))
    schemes = (SWParams(), SWParams(match=1, mismatch=1, gap_open=0, gap_extend=1))
    rng = np.random.default_rng(seed)
    for lq, lt in sw_tiers():
        q, t = sw_tier_batch(rng, SMOKE_B, lq, lt)
        qd, td = jax.device_put(q), jax.device_put(t)
        for params in schemes:
            compiled = kernel.lower(qd, td, params=params).compile()
            got = [np.asarray(x) for x in compiled(qd, td)]
            want = [np.asarray(x) for x in sw_score(qd, td, params)]
            for name, a, b in zip(("score", "q_end", "t_end"), got, want):
                bad = np.flatnonzero(a != b)
                if len(bad):
                    raise AssertionError(
                        f"SW {lq}x{lt} {params}: {name} differs at pairs "
                        f"{bad[:8].tolist()}: kernel {a[bad[:8]].tolist()} vs "
                        f"scan {b[bad[:8]].tolist()}")
        log(f"[2] SW {lq}x{lt} B={SMOKE_B}: kernel == scan under "
            f"{len(schemes)} schemes (max score {int(want[0].max())}); "
            f"memory: {compiled.memory_analysis()}")


class _Outcomes:
    """pytest plugin: counts test outcomes of the in-process run."""

    def __init__(self):
        self.counts = collections.Counter()

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests() -> None:
    import pytest

    tally = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "--rootdir", str(REPO),
         str(REPO / "tests")],
        plugins=[tally],
    )
    log(f"[2] gpu-marked tests: {dict(tally.counts)} (pytest exit {int(rc)})")
    if rc != 0 or tally.counts["passed"] == 0 or tally.counts["skipped"]:
        raise AssertionError("gpu-marked tests did not all run and pass")


# -- phase 3 -----------------------------------------------------------------

def region_step_inputs(seed: int):
    """bench-scale shapes: 8 regions x 256 reads of 128 bp against 4 kb
    references, 16 SW pairs of 256 x 512 per region."""
    G, R, L, LREF, GB, GLQ, GLT = 8, 256, 128, 4096, 16, 256, 512
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 4, size=(G, R, L)).astype(np.int8),
        np.full((G, R), L, dtype=np.int32),
        rng.integers(0, 4, size=(G, LREF)).astype(np.int8),
        np.full((G,), LREF, dtype=np.int32),
        rng.integers(0, 4, size=(G, GB, GLQ)).astype(np.int8),
        rng.integers(0, 4, size=(G, GB, GLT)).astype(np.int8),
    )


def _assert_same(name, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{name}: output {i} differs")


def phase_region_step(seed: int) -> None:
    import jax

    from breakmer_tpu.parallel.step import make_region_step

    inputs = region_step_inputs(seed)
    step = make_region_step(mesh=None, k=15)
    hlo = step.lower(*inputs).as_text()
    if "dot_general" in hlo or "convolution" in hlo:
        raise AssertionError("region step has a matrix product on the device")
    gpu_out = jax.device_get(step(*inputs))
    cpu = jax.devices("cpu")[0]
    cpu_out = jax.device_get(step(*jax.device_put(inputs, cpu)))
    _assert_same("region step GPU vs CPU", gpu_out, cpu_out)
    log(f"[3] region step {inputs[0].shape} reads, {inputs[4].shape} SW pairs: "
        f"GPU == CPU exactly (kernel on the GPU, scan on the CPU)")


# -- phase 4 -----------------------------------------------------------------

def _random_chrom(rng: np.random.Generator, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n, dtype=np.uint8)].tobytes().decode("ascii")


def build_panel(work: Path, seed: int, n_regions: int = 200,
                chrom_bp=(60_000_000, 40_000_000)):
    """Panel under ``work``: genome FASTA (chr1 holds the targets, chr2 the
    translocation partners), targets BED, errored sample SAM and a JSON
    config. Every 20th target (from the 10th) carries one planted SV,
    cycling through KINDS, tiled at ~100x junction depth; every target
    has ~50x background pairs. Returns (config path, planted, targets,
    genome bp) with planted = {gene: (kind, [(chrom, pos), ...])}, the
    junctions of each planted event."""
    sys.path.insert(0, str(REPO))
    from breakmer_tpu.io.fasta import write_fasta
    from tests.fixtures import ErrorModel, SamBuilder
    from tests.scenarios import plant_sv

    rng = np.random.default_rng(seed)
    genome = {name: _random_chrom(rng, n) for name, n in zip(("chr1", "chr2"), chrom_bp)}
    rng = np.random.default_rng(seed + 1)  # events do not depend on genome size
    write_fasta(work / "genome.fa", genome)
    sam = SamBuilder(genome, error_model=ErrorModel(), error_seed=seed)
    span, gap, first = 1200, 800, 50_000
    planted = {}
    lines = []
    for g in range(n_regions):
        start = first + g * (span + gap)
        end = start + span
        gene = f"T{g:03d}"
        lines.append(f"chr1\t{start}\t{end}\t{gene}\n")
        if g % 20 == 10:
            kind = KINDS[(g // 20) % len(KINDS)]
            _, check = plant_sv(rng, genome, sam, gene, start, end, kind,
                                read_step=1)
            planted[gene] = (kind, check.junctions)
        sam.add_background_pairs("chr1", start - 300, end + 300, step=4,
                                 prefix=f"bg{g}")
    (work / "targets.bed").write_text("".join(lines))
    sam.write(work / "sample.sam")
    cfg = {
        "analysis_name": "smoke",
        "analysis_dir": str(work / "analysis"),
        "targets_bed_file": str(work / "targets.bed"),
        "reference_fasta": str(work / "genome.fa"),
        "reference_data_dir": str(work / "refdata"),
        "sample_bam_file": str(work / "sample.sam"),
        "indel_sr_thresh": 2,
        "trl_sr_thresh": 2,
        "rearr_sr_thresh": 2,
        "batch_regions": True,
    }
    path = work / "config.json"
    path.write_text(json.dumps(cfg, indent=1))
    return path, planted, n_regions, sum(chrom_bp)


_TYPE_OK = {
    "ins": lambda r: r["sv_subtype"] in ("I", "ins"),
    "del": lambda r: r["sv_subtype"] in ("D", "del"),
    "dup": lambda r: r["sv_subtype"] == "tandem_dup",
    "inv": lambda r: r["sv_subtype"] == "inversion",
    "trl": lambda r: r["sv_type"] == "trl",
}


def _breakpoints(row: dict):
    for part in row["target_breakpoints"].split(","):
        chrom, _, span = part.rpartition(":")
        for p in span.split("-"):
            yield chrom, int(p)


def check_calls(svs_path: Path, planted: dict, tol: int = 30) -> dict:
    """Each planted event needs a call of its type in its target with a
    breakpoint within ``tol`` bp of a planted junction; SV-free targets
    need no call at all. Returns calls per kind."""
    from breakmer_tpu.report import read_svs_out

    by_gene = collections.defaultdict(list)
    for row in read_svs_out(svs_path):
        by_gene[row["genes"].split(",")[0]].append(row)
    stray = sorted(g for g in by_gene if g not in planted)
    if stray:
        raise AssertionError(f"calls in SV-free targets: {stray[:10]}")
    found = {}
    for gene, (kind, junctions) in planted.items():
        hits = [
            r for r in by_gene.get(gene, [])
            if _TYPE_OK[kind](r) and any(
                c == jc and abs(p - jp) <= tol
                for c, p in _breakpoints(r) for jc, jp in junctions)
        ]
        if not hits:
            got = [(r["sv_type"], r["sv_subtype"], r["target_breakpoints"])
                   for r in by_gene.get(gene, [])]
            raise AssertionError(f"{gene}: planted {kind} at {junctions} not "
                                 f"called; calls there: {got}")
        found[gene] = kind
    return dict(collections.Counter(found.values()))


def run_panel(config: Path, analysis_dir: Path) -> dict:
    """One ``cli run`` of the panel; returns its metrics.json plus the
    wall time of the whole call."""
    from breakmer_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(["run", str(config), "--analysis-dir", str(analysis_dir)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli run exited {rc}")
    metrics = json.loads((analysis_dir / "metrics.json").read_text())
    if metrics["errors"]:
        raise AssertionError(f"region errors: {metrics['errors']}")
    metrics["wall_s"] = wall
    return metrics


def _reads(metrics: dict) -> int:
    return sum(r.get("records", 0) for r in metrics["regions"].values())


def phase_panel(seed: int, work: Path) -> None:
    import jax

    t0 = time.perf_counter()
    config, planted, n_regions, genome_bp = build_panel(work, seed)
    log(f"[4] panel: {n_regions} targets, {len(planted)} planted SVs "
        f"({', '.join(sorted(set(k for k, _ in planted.values())))}), "
        f"{genome_bp / 1e6:.0f} Mbp genome; built in "
        f"{time.perf_counter() - t0:.1f}s")
    card = card_line()
    for label in ("cold", "warm"):
        adir = work / f"analysis_{label}"
        m = run_panel(config, adir)
        kinds = check_calls(adir / "output" / "smoke_svs.out", planted)
        run_s = m["elapsed_s"]
        log(f"[4] {label}: {m['calls']} calls, planted found {kinds}, 0 in "
            f"SV-free targets; run {run_s}s, set-up {m['wall_s'] - run_s:.2f}s "
            f"(wall {m['wall_s']:.2f}s)")
    reads = _reads(m)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[4] warm on {card}: {n_regions / m['elapsed_s']:.2f} regions/s, "
        f"{reads / m['elapsed_s']:.0f} reads/s ({reads} reads); device peak "
        f"{peak} bytes in use")
    log(f"[4] warm stage_s: {json.dumps(m['stage_s'])}")
    log(f"[4] warm SW: {json.dumps(m.get('sw'))}")
    served = m.get("sw", {}).get("launches_by_impl", {})
    if set(served) != {"cuda"}:
        raise AssertionError(f"SW launches served by {served}, not the kernel")


# -- --chips 4 -----------------------------------------------------------------

def phase_four_cards(seed: int, work: Path, n_chips: int) -> None:
    import jax

    from breakmer_tpu.align.index import GenomeIndex
    from breakmer_tpu.encode import encode_seq
    from breakmer_tpu.parallel.index_shard import ShardedGenomeIndex, make_shard_mesh
    from breakmer_tpu.parallel.mesh import make_mesh_2d
    from breakmer_tpu.parallel.step import make_region_step

    # the region step sharded over a regions x pairs mesh of every card
    inputs = region_step_inputs(seed)
    mesh = make_mesh_2d(n_chips)
    sharded = jax.device_get(make_region_step(mesh=mesh, k=15)(*inputs))
    single = jax.device_get(make_region_step(mesh=None, k=15)(*inputs))
    _assert_same("sharded region step", sharded, single)
    log(f"[4c] region step on a {'x'.join(map(str, mesh.devices.shape))} mesh "
        f"== unsharded step, exactly")

    # the panel: batched (k-mer launches sharded over the local mesh) vs
    # the serial path, which runs on one card
    config, planted, n_regions, _ = build_panel(work, seed)
    batched = work / "analysis_batched"
    m = run_panel(config, batched)
    check_calls(batched / "output" / "smoke_svs.out", planted)
    serial = work / "analysis_serial"
    cfg = json.loads(config.read_text())
    cfg["batch_regions"] = False
    serial_config = work / "config_serial.json"
    serial_config.write_text(json.dumps(cfg))
    ms = run_panel(serial_config, serial)
    a = (batched / "output" / "smoke_svs.out").read_bytes()
    b = (serial / "output" / "smoke_svs.out").read_bytes()
    if a != b:
        raise AssertionError("mesh-batched calls differ from the serial path")
    log(f"[4c] panel {n_regions} targets: batched over {n_chips} cards "
        f"({m['elapsed_s']}s) == serial on one card ({ms['elapsed_s']}s), "
        f"{m['calls']} calls byte-identical")

    # the sharded seed table against the replicated index
    cache = next((work / "refdata").glob("*_genome_index_v2_k*.npz"))
    gi = GenomeIndex.load(cache)
    si = ShardedGenomeIndex(gi, make_shard_mesh(n_chips))
    rng = np.random.default_rng(seed + 1)
    fasta = (work / "genome.fa").read_text().split(">")[1:]
    genome = {r.split("\n", 1)[0]: r.split("\n", 1)[1].replace("\n", "") for r in fasta}
    n_q = 0
    for chrom, seq in genome.items():
        for _ in range(25):
            p = int(rng.integers(0, len(seq) - 400))
            q = encode_seq(seq[p:p + int(rng.integers(100, 400))])
            want = [(w.chrom, w.t_start, w.t_end, w.strand) for w in gi.candidates(q)]
            got = [(w.chrom, w.t_start, w.t_end, w.strand) for w in si.candidates(q)]
            if got != want:
                raise AssertionError(f"sharded index differs at {chrom}:{p}")
            n_q += 1
    log(f"[4c] sharded genome index over {n_chips} cards == replicated index "
        f"on {n_q} queries")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card checks, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = phase_environment(args.chips)
    work = Path(tempfile.mkdtemp(prefix="breakmer_smoke_"))
    try:
        if args.chips == 4:
            phase_four_cards(args.seed, work, args.chips)
        else:
            phase_sw(args.seed)
            phase_gpu_tests()
            phase_region_step(args.seed)
            phase_panel(args.seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
