"""The benchmark of rakau_tpu_torch on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Sets up the cell named in BENCHMARK.json,
measures a closed loop of its entry for --seconds (--trace 1: profiles
the traffic's traced calls instead), judges the outputs against the plain
float64 reference and prints one JSON line last on standard output. Fails
with no result where there is no CUDA card."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache at a fixed place inside the checkout
    # (the kernels' own .so files build into rakau_tpu_torch/_build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
