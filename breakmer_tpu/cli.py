"""CLI entry point.

Reference: breakmer.py ``__main__`` (SURVEY.md §2 #1): optparse CLI taking
a config file plus option overrides; modes: full run and reference-data
preset (SURVEY.md §3.4). Usage:

    python -m breakmer_tpu.cli run <config> [--nprocs N] [--genes A,B] ...
    python -m breakmer_tpu.cli preset <config>
    python -m breakmer_tpu.cli version
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from breakmer_tpu import __version__
from breakmer_tpu.config import Config
from breakmer_tpu.runner import Runner


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="breakmer_tpu",
        description="JAX structural-variant caller (BreaKmer-class)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("config", help="JSON or key=value config file")
        sp.add_argument("--analysis-dir", dest="analysis_dir")
        sp.add_argument("--analysis-name", dest="analysis_name")
        sp.add_argument("-p", "--nprocs", dest="nprocs", type=int)
        sp.add_argument("-g", "--gene-list", dest="gene_list")
        sp.add_argument("--kmer-size", dest="kmer_size", type=int)
        sp.add_argument("--indel-size", dest="indel_size", type=int)
        sp.add_argument("--keep-repeat-regions", dest="keep_repeat_regions",
                        action="store_true", default=None)
        sp.add_argument("--keep-intron-vars", dest="keep_intron_vars",
                        action="store_true", default=None)
        sp.add_argument("--log-level", dest="log_level")

    run_p = sub.add_parser("run", help="full analysis run")
    add_common(run_p)
    run_p.add_argument("--resume", action="store_true",
                       help="resume from the per-region completion ledger")
    run_p.add_argument("--profile", action="store_true",
                       help="capture a jax.profiler trace to <analysis_dir>/trace")

    preset_p = sub.add_parser(
        "preset", help="pre-build reference data caches (reference preset mode)"
    )
    add_common(preset_p)

    sub.add_parser("version", help="print version")
    sub.add_parser(
        "check",
        help="environment self-check (reference: utils.py tool self-tests)",
    )
    return p


def load_config(args: argparse.Namespace) -> Config:
    overrides = {
        k: v
        for k, v in vars(args).items()
        if k not in ("command", "config", "resume") and v is not None
    }
    return Config.from_file(args.config, **overrides)


def run_check() -> int:
    """Startup self-checks. The reference probes its external binaries
    (utils.py test_jellyfish/test_cutadapt, SURVEY.md §2 #20); here the
    dependencies are the JAX backend, the SW implementation the dispatcher
    picks for it, and the native IO library."""
    import jax

    from breakmer_tpu import native
    from breakmer_tpu.device import configure

    failures = 0
    platform = configure("auto")
    print(f"jax {jax.__version__}; backend: {platform}; "
          f"devices: {[str(d) for d in jax.devices()]}")
    try:
        import jax.numpy as jnp

        from breakmer_tpu.ops.kmer import kmer_codes

        km, _ = kmer_codes(jnp.zeros((2, 20), jnp.int8),
                           jnp.full((2,), 20, jnp.int32), 15)
        km.block_until_ready()
        print("kmer engine: OK")
    except Exception as exc:
        failures += 1
        print(f"kmer engine: FAIL ({exc})")
    try:
        import numpy as np

        from breakmer_tpu.ops.sw import sw_impl, sw_score_batch

        sw_score_batch(np.zeros((8, 128), np.int8), np.zeros((8, 128), np.int8))
        print(f"SW engine ({sw_impl(platform)}): OK")
    except Exception as exc:
        failures += 1
        print(f"SW engine: FAIL ({exc})")
    print(f"native IO library: {'OK' if native.available() else 'not built (pure-python fallbacks active)'}")
    print("self-check:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(__version__)
        return 0
    if args.command == "check":
        return run_check()
    cfg = load_config(args)
    runner = Runner(cfg)
    runner.setup()
    if args.command == "preset":
        runner.preset_ref_data()
        print(f"preset complete: {len(runner.targets)} targets cached")
        return 0
    if getattr(args, "profile", False):
        # device + host trace (SURVEY.md §5 tracing/profiling aux subsystem)
        import jax

        with jax.profiler.trace(f"{cfg.analysis_dir}/trace"):
            runner.run(resume=getattr(args, "resume", False))
    else:
        runner.run(resume=getattr(args, "resume", False))
    print(f"{runner.total_calls} SV calls written to "
          f"{cfg.analysis_dir}/output/{cfg.analysis_name}_svs.out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
