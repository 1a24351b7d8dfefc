"""Multi-card parallelism: mesh setup, region batching, sharded device step.

The reference's only parallelism is a host multiprocessing pool over
target regions (SURVEY.md §2b — reference: runner.run + Pool(nprocs)).
Here the equivalent is data parallelism over regions expressed with
``jax.sharding`` + ``shard_map`` over a device mesh:

  axis "regions": regions scattered across devices (the Pool analog)
  axis "pairs":   the (contig, window) SW batch within a region, sharded
                  so one region's realignment can also fan out
  reference data: replicated per device (v1; chromosome-sharded lookup is
                  the v2 path — SURVEY.md §2b "index sharding")
  merge:          per-region partials all-gathered into one call set
                  (replaces the serial runner aggregation loop)

XLA inserts the collectives from the shardings and runs them over NVLink
between the cards of one machine (NCCL underneath); the program itself
calls no MPI or NCCL (SURVEY.md §2c).
"""

from breakmer_tpu.parallel.mesh import make_mesh_2d, mesh_axes
from breakmer_tpu.parallel.regions import RegionBatch, pack_region_batches
from breakmer_tpu.parallel.step import make_region_step

__all__ = [
    "make_mesh_2d", "mesh_axes", "RegionBatch", "pack_region_batches",
    "make_region_step",
]
