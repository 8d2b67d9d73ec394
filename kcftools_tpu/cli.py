"""kcftools-tpu command line driver.

Subcommand registry mirrors the reference (KCFTOOLS.java:16-28):
getVariations, cohort, findIBS, splitKCF, getAttributes, kcf2tsv,
increaseWindow, kcf2plink, scoreRecalc, kcf2gt - plus the new ``count``
(built-in k-mer counter; the reference depends on external KMC3).
"""

import argparse
import os
import sys
import time

from . import __version__
from .utils.logger import KcfError, Logger


def build_parser():
    parser = argparse.ArgumentParser(
        prog="kcftools",
        description="k-mer based genomic variation screening on "
        "accelerators",
    )
    parser.add_argument("--version", action="version", version=__version__)
    subparsers = parser.add_subparsers(dest="command", required=True)
    from .plugins import PLUGINS

    for plugin in PLUGINS:
        plugin.add_parser(subparsers)
    return parser


def _print_memory_usage():
    """Peak RSS report (analog of HelperFunctions.printMaxMemoryUsage)."""
    try:
        import resource

        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        Logger.info(
            "KCFTOOLS", f"Peak host memory: {peak_kb / (1024 * 1024):.2f} GB"
        )
    except Exception:
        pass


def _maybe_init_distributed():
    """Multi-host init from env (no-op single-process):
    KCFTOOLS_COORDINATOR=host:port KCFTOOLS_NUM_PROCS=N KCFTOOLS_PROC_ID=i
    The device mesh code then spans all hosts."""
    n = int(os.environ.get("KCFTOOLS_NUM_PROCS", "1"))
    if n > 1:
        from .parallel.mesh import init_distributed

        init_distributed(
            os.environ.get("KCFTOOLS_COORDINATOR"),
            n,
            int(os.environ.get("KCFTOOLS_PROC_ID", "0")),
        )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    args = parser.parse_args(argv)
    _maybe_init_distributed()
    start = time.time()

    # profiling: set KCFTOOLS_PROFILE=<dir> to capture a JAX/XLA trace
    profile_dir = os.environ.get("KCFTOOLS_PROFILE")
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    try:
        args.func(args)
    except KcfError:
        return 1
    finally:
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
            Logger.info("KCFTOOLS", f"Profiler trace written to {profile_dir}")
    _print_memory_usage()
    Logger.info("KCFTOOLS", f"Total execution time: {time.time() - start:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
