"""Time the CUDA SW kernel against the XLA scan on one GPU, in one process.

    python tools/sw_kernel_vs_scan.py [--reps 7] [--pairs 8] [--out FILE]

1. Every realignment tier (contig tiers x window tiers) at B = 512, the
   pairs of chip_smoke.py phase 2: warm, ``block_until_ready``, the median
   of ``--reps`` runs of each implementation.
2. The chip_smoke.py phase-4 panel through ``cli run``: one cold run per
   implementation, then ``--pairs`` pairs of warm runs, alternating which
   implementation goes first (kernel, scan, scan, kernel, ...). The scan
   serves the panel by calling it directly: ops.sw's dispatcher is
   replaced inside this process only.

Prints one line per measurement and writes all numbers, with the card's
name and power limit, to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def median_s(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_tiers(reps: int, seed: int) -> list:
    import jax
    import numpy as np

    from breakmer_tpu.ops.sw import SWParams, sw_score
    from breakmer_tpu.ops.sw_cuda import sw_score_cuda

    params = SWParams()
    kernel = jax.jit(sw_score_cuda, static_argnames=("params",))
    rng = np.random.default_rng(seed)
    rows = []
    for lq, lt in chip_smoke.sw_tiers():
        q, t = chip_smoke.sw_tier_batch(rng, chip_smoke.SMOKE_B, lq, lt)
        qd, td = jax.device_put(q), jax.device_put(t)
        k = median_s(lambda: kernel(qd, td, params=params), reps)
        s = median_s(lambda: sw_score(qd, td, params), reps)
        cells = chip_smoke.SMOKE_B * lq * lt
        row = {"lq": lq, "lt": lt, "B": chip_smoke.SMOKE_B, "kernel_s": k,
               "scan_s": s, "kernel_gcups": cells / k / 1e9,
               "scan_gcups": cells / s / 1e9, "scan_over_kernel": s / k}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def _scan_dispatch():
    """Serve every SW launch of the panel with the scan."""
    from breakmer_tpu.ops import sw

    return mock.patch.multiple(
        sw,
        sw_score_auto=lambda q, t, params=sw.SWParams(): sw.sw_score(q, t, params),
        sw_impl=lambda platform, params=sw.SWParams(): "scan",
    )


def time_panel(seed: int, work: Path, pairs: int) -> dict:
    config, planted, n_regions, _ = chip_smoke.build_panel(work, seed)
    runs = {"kernel": [], "scan": []}

    def run(impl: str, label: str) -> None:
        adir = work / f"analysis_{impl}_{label}"
        if impl == "scan":
            with _scan_dispatch():
                m = chip_smoke.run_panel(config, adir)
        else:
            m = chip_smoke.run_panel(config, adir)
        chip_smoke.check_calls(adir / "output" / "smoke_svs.out", planted)
        served = m["sw"]["launches_by_impl"]
        want = "cuda" if impl == "kernel" else "scan"
        if set(served) != {want}:
            raise AssertionError(f"{impl} run served by {served}")
        rec = {"label": label, "run_s": m["elapsed_s"], "wall_s": m["wall_s"],
               "realign_s": m["stage_s"].get("realign"),
               "sw_wall_s": m["sw"]["wall_s"], "sw_launches": m["sw"]["launches"]}
        if label != "cold":
            runs[impl].append(rec)
        print(json.dumps({"impl": impl, **rec}), flush=True)

    run("kernel", "cold")
    run("scan", "cold")
    for i in range(pairs):
        for impl in (("kernel", "scan") if i % 2 == 0 else ("scan", "kernel")):
            run(impl, f"warm{i}")
    return {
        "targets": n_regions,
        "runs": runs,
        "warm_median": {
            impl: {key: statistics.median(r[key] for r in v)
                   for key in ("run_s", "realign_s", "sw_wall_s")}
            for impl, v in runs.items()
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "sw_kernel_vs_scan.json")
    args = ap.parse_args()
    device = chip_smoke.phase_environment(1)
    card = chip_smoke.card_line()
    work = Path(tempfile.mkdtemp(prefix="breakmer_swtime_"))
    try:
        result = {"card": card, "device": device, "tiers": time_tiers(args.reps, args.seed),
                  "panel": time_panel(args.seed, work, args.pairs)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"card": card, "panel_warm_median": result["panel"]["warm_median"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
