"""Runs one cell of the benchmark once and prints its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's parts are found by name from ``BENCHMARK.json`` at the root of
the checkout (``harness/cell.py``). The port's nvcc builds go to
``perfbench/.cache/kernels`` and Triton's cache to
``perfbench/.cache/triton``, so only a checkout's first run builds. The
last line of standard output is the result, a JSON object; the numbers
that decide ``correct`` are the last lines of standard error. Without as
many CUDA devices as the cell asks for it prints no result and exits 3.
"""

import time

START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # Before the port is imported: it reads the build directory at use.
    os.environ["SEED_RL_TORCH_BUILD_DIR"] = str(CACHE)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import runner

    return runner.run(args, START)


if __name__ == "__main__":
    sys.exit(main())
