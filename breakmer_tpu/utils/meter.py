"""Run-wide stage / throughput meter (SURVEY.md §5 tracing-profiling row).

The reference's only observability is elapsed-time log prose
(``sv_processor.py runner.run`` ``time.time()`` deltas, reconstructed —
SURVEY.md §5). Here a process-global meter accumulates per-stage wall
seconds and Smith-Waterman cell-updates across a run; the runner writes
the snapshot — including SW launches per implementation and run-level
wall-clock GCUPS — into ``<analysis_dir>/metrics.json``.

Under multihost each process meters itself; process 0's metrics.json
reports process 0's stages (region work is host-partitioned, so every
process runs the same stage mix over its own shard).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Meter:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.stage_s: dict = defaultdict(float)
        self.sw_cells = 0
        self.sw_s = 0.0
        self.sw_launches = 0
        self.sw_launches_by_impl: dict = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_s[name] += time.perf_counter() - t0

    def add_sw(self, cells: int, secs: float, impl: str) -> None:
        """One SW launch of ``cells`` cell updates, served by ``impl``
        (ops.sw.sw_impl: "cuda" or "scan")."""
        self.sw_cells += int(cells)
        self.sw_s += secs
        self.sw_launches += 1
        self.sw_launches_by_impl[impl] += 1

    def snapshot(self) -> dict:
        out = {
            "stage_s": {k: round(v, 4) for k, v in sorted(self.stage_s.items())}
        }
        if self.sw_launches:
            out["sw"] = {
                "launches": self.sw_launches,
                "launches_by_impl": dict(sorted(self.sw_launches_by_impl.items())),
                "cells": self.sw_cells,
                "wall_s": round(self.sw_s, 4),
                # GCUPS over the host's wall time of each launch: upload,
                # dispatch, kernel and fetch (a cold run includes compiles;
                # 6 decimals: a cold-compile CPU run can be ~1e-5 GCUPS)
                "gcups_wall": (
                    round(self.sw_cells / self.sw_s / 1e9, 6) if self.sw_s > 0 else 0.0
                ),
            }
        return out


# Process-global, intentionally unsynchronized. INVARIANT: one active
# Runner per process — Runner.run() resets it, and the device stages that
# feed it (sw_score_batch) run on the runner's thread. Library callers
# wanting isolated counters should instantiate their own Meter; host
# worker THREADS inside one runner are fine (adds are GIL-atomic enough
# for coarse wall metrics). With nprocs>1 worker threads, stage() sums
# per-thread wall across overlapping regions, so a stage's total can
# exceed the run's wall clock — read stage_s as aggregate stage cost.
METER = Meter()
