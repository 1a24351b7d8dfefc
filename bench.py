"""Device microbenchmark on one GPU: SW throughput and the region step.

    python bench.py

Smith-Waterman GCUPS (giga cell-updates per second) of the implementation
the dispatcher serves on this platform, and of the XLA scan, on 512
(contig, window) pairs of 256 x 512 — a panel realignment burst at the
(256, 512) pad tier; then the jitted region step (k-mer subtraction + SW)
in regions/s. Each time is the median of warm runs that end in
``block_until_ready``. Prints the card's name and power limit, then one
JSON line. Fails without a GPU. The end-to-end panel numbers come from
``chip_smoke.py``.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np

B, LQ, LT = 512, 256, 512
REPS = 20


def median_s(fn, *args) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_sw() -> dict:
    import jax

    from breakmer_tpu.ops.sw import sw_impl, sw_score, sw_score_auto

    rng = np.random.default_rng(0)
    q = jax.device_put(rng.integers(0, 4, size=(B, LQ)).astype(np.int8))
    t = jax.device_put(rng.integers(0, 4, size=(B, LT)).astype(np.int8))
    auto = jax.jit(sw_score_auto)
    got = [np.asarray(x) for x in auto(q, t)]
    want = [np.asarray(x) for x in sw_score(q, t)]
    for a, b in zip(got, want):
        if not np.array_equal(a, b):
            raise AssertionError("dispatched SW disagrees with the scan")
    cells = B * LQ * LT
    return {
        "sw_impl": sw_impl(jax.default_backend()),
        "sw_gcups": cells / median_s(auto, q, t) / 1e9,
        "sw_scan_gcups": cells / median_s(sw_score, q, t) / 1e9,
        "sw_cells_per_batch": cells,
    }


def bench_region_step() -> dict:
    import jax

    from chip_smoke import region_step_inputs
    from breakmer_tpu.parallel.step import make_region_step

    inputs = tuple(jax.device_put(x) for x in region_step_inputs(1))
    step = make_region_step(mesh=None, k=15)
    dt = median_s(step, *inputs)
    G, R = inputs[0].shape[:2]
    return {
        # the jitted device step alone (no host stages, no IO)
        "device_step_regions_per_s": G / dt,
        "device_step_reads_per_s": G * R / dt,
        "region_step_ms": dt * 1e3,
    }


def main() -> None:
    from breakmer_tpu.device import configure
    from chip_smoke import card_line

    configure("gpu")
    import jax

    card = card_line()
    print(f"card: {card}", flush=True)
    sw = bench_sw()
    step = bench_region_step()
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "sw_gcups",
        "value": sw["sw_gcups"],
        "unit": "GCUPS",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "detail": {**sw, **step},
    }))


if __name__ == "__main__":
    main()
