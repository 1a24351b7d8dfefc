"""Panel throughput scaling sweep: regions/s and reads/s vs panel size,
with a SAME-FIXTURE CPU column for every point.

Each point runs on BOTH platforms so the CPU/GPU comparison is made on
identical inputs, and adds deeper-coverage tiers (read_step 2; read_step
1 at 250 bp reads, ~9x the base-pairs of the default) where the device
k-mer + SW path has the most work.

Method notes: each (point, platform) runs once cold and twice warm in a
SUBPROCESS (jax cannot switch platforms mid-process); the reported
number is the MEDIAN warm, cold_s recorded beside it. The subprocesses
run one at a time — a CPU process, then the GPU process, per point — so
only one process holds the card. Run on an otherwise idle host.

Usage: python tools/bench_panel_scaling.py [out.json]
       python tools/bench_panel_scaling.py --one <platform> <n_genes> <step> <read_len>
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SIZES = [20, 50, 100, 200, 400]
# deep tiers at 100 genes: (read_step, read_len)
DEEP_TIERS = [(2, 100), (1, 250)]


def one_point(platform: str, n_genes: int, read_step: int,
              read_len: int) -> dict:
    from bench_panel import build_panel, run_once
    from breakmer_tpu.device import configure

    got = configure(platform)
    work = Path(tempfile.mkdtemp(prefix="breakmer_scale_"))
    try:
        t0 = time.time()
        cfg = build_panel(work, n_genes, read_step, read_len=read_len)
        fixture_s = time.time() - t0
        cold = run_once(cfg)
        warms = []
        for _ in range(2):
            shutil.rmtree(cfg.analysis_dir, ignore_errors=True)
            warms.append(run_once(cfg))
        warm = sorted(warms, key=lambda w: w["elapsed_s"])[len(warms) // 2]
        return {
            "platform": got,
            "n_genes": n_genes,
            "read_step": read_step,
            "read_len": read_len,
            "targets": warm["targets"],
            "records": warm["records"],
            "calls": warm["calls"],
            "fixture_s": round(fixture_s, 2),
            "cold_s": round(cold["elapsed_s"], 2),
            "warm_s": round(warm["elapsed_s"], 3),
            "warm_s_all": [round(w["elapsed_s"], 3) for w in warms],
            "regions_per_s": round(warm["targets"] / warm["elapsed_s"], 1),
            "reads_per_s": round(warm["records"] / warm["elapsed_s"], 1),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_sub(platform: str, n_genes: int, step: int, read_len: int) -> dict:
    """One (point, platform) in a fresh subprocess (platform is fixed at
    first jax op; only a new process can switch)."""
    cmd = [sys.executable, __file__, "--one", platform, str(n_genes),
           str(step), str(read_len)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"scaling subprocess produced no JSON: {proc.stderr[-2000:]}")


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        sys.path.insert(0, str(REPO / "tools"))
        print(json.dumps(one_point(sys.argv[2], int(sys.argv[3]),
                                   int(sys.argv[4]), int(sys.argv[5]))))
        return
    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    points = []
    shapes = [(n, 6, 100) for n in SIZES] + [
        (100, step, rl) for step, rl in DEEP_TIERS]
    for n, step, rl in shapes:
        row = {"n_genes": n, "read_step": step, "read_len": rl}
        # one at a time: cpu, then gpu, on the identical fixture shape
        for platform in ("cpu", "gpu"):
            r = run_sub(platform, n, step, rl)
            row[r["platform"]] = {
                k: r[k] for k in ("cold_s", "warm_s", "warm_s_all",
                                  "regions_per_s", "reads_per_s",
                                  "records", "calls")}
        if {"cpu", "gpu"} <= set(row):
            row["gpu_speedup_warm"] = round(
                row["cpu"]["warm_s"] / row["gpu"]["warm_s"], 3)
        print(json.dumps(row), flush=True)
        points.append(row)
    artifact = {
        "metric": "panel_scaling_cpu_vs_gpu",
        "points": points,
        "note": (
            "warm_s is the comparable number (median of 2 same-process "
            "warm runs, per-platform subprocess)."
        ),
    }
    line = json.dumps(artifact)
    print(line)
    if out_path is not None:
        out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
