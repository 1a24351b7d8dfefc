"""Multi-host orchestration (BASELINE.json config #5).

The reference is strictly single-host (SURVEY.md §2c). Here a panel run
scales across machines as: one process per machine
(``jax.distributed.initialize``), target regions partitioned
round-robin across processes (each with its own ledger shard for
region-granular resume), device-level work inside each process using the
local mesh, and the call set merged by process 0 from the ledger shards
on the shared filesystem (the host-side twin of the device all-gather
merge in parallel/step.py).

Run ONE process per machine: each process opens every local card (its
batched k-mer launches shard over all of them), and a JAX process
reserves most of each card's memory when it starts, so a second process
on the same machine fails for want of memory. The partition/merge logic
is exercised by tests with several CPU processes on one host.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import jax

from breakmer_tpu.utils.logging import get_logger

log = get_logger("multihost")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize the process group when configured for >1 process;
    returns (process_index, process_count). Safe to call single-process.
    """
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def partition_targets(
    names: Sequence[str], process_index: int, process_count: int
) -> List[str]:
    """Deterministic round-robin partition of target names — the
    multi-host analog of the reference pool handing regions to workers.
    Round-robin (not contiguous blocks) balances panels where neighboring
    genes have correlated read depth."""
    return [n for i, n in enumerate(names) if i % process_count == process_index]


def shard_ledger_path(analysis_dir: str | Path, process_index: int) -> Path:
    return Path(analysis_dir) / f"ledger_p{process_index}.json"


def merge_ledger_shards(
    analysis_dir: str | Path,
    target_order: Sequence[str],
    process_count: int,
    wait_timeout_s: float = 600.0,
    poll_s: float = 2.0,
) -> Dict[str, dict]:
    """Process 0: wait for every shard to be complete, merge to one
    ledger keyed in panel order. A shard is complete when it contains all
    the targets of its partition (each worker writes after every region,
    so partial shards are visible — completeness, not existence, is the
    barrier)."""
    deadline = time.time() + wait_timeout_s
    merged: Dict[str, dict] = {}
    for p in range(process_count):
        want = set(partition_targets(list(target_order), p, process_count))
        path = shard_ledger_path(analysis_dir, p)
        while True:
            have: Dict[str, dict] = {}
            if path.exists():
                try:
                    have = json.loads(path.read_text())
                except json.JSONDecodeError:
                    have = {}  # mid-write; retry
            # overlay the shard's append log (workers checkpoint regions
            # as O(1) JSONL appends; the snapshot only exists once a
            # worker finalizes — see Runner._append_ledger)
            ap = path.with_suffix(".jsonl")
            if ap.exists():
                for line in ap.read_text().splitlines():
                    if line.strip():
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue  # torn tail line mid-write
                        have[rec["name"]] = rec["entry"]
            if want.issubset(have):
                merged.update({k: v for k, v in have.items() if k in want})
                break
            if time.time() > deadline:
                missing = sorted(want - set(have))
                log.warning(
                    "shard %d incomplete after %.0fs (missing %s) — "
                    "merging what exists",
                    p, wait_timeout_s, missing[:5],
                )
                merged.update({k: v for k, v in have.items() if k in want})
                break
            time.sleep(poll_s)
    return merged
