"""Run one cell of the benchmark once and print its result line.

    python3 ctd_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.  It
sets up the cell (weights, the traffic pool from the seed, the kernels'
build, a warm-up of the cell's own shapes), measures for ``--seconds``
(with ``--trace 1`` under the profiler, reporting the cell's per-layer
metrics), checks a sample of what the timed path produced against the
plain reference in ``ctd_bench/reference``, and prints one JSON line as the
last line of its standard output.  It exits non-zero, printing no result,
without enough CUDA devices, or if JAX or the JAX package was imported.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".ctd_bench_cache")
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
# one host thread for torch's and the BLAS's thread pools: the stream's main
# thread is saturated, and seven idle pool threads beside it spread the rate
# between processes (PERF.md, section 2)
os.environ["OMP_NUM_THREADS"] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from ctd_bench import harness

    return harness.main(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
