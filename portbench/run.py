"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port), one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA
devices.  The cells, their metrics and their bounds are in
``BENCHMARK.json``; each cell's files are under ``portbench/`` (see
``portbench/lib/spec.py``).  Prints one JSON line as the last line of
standard output.  Every cache the program builds stays in ``build/``
inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}


def setup_env() -> None:
    """Fixed cache directories inside the checkout, no JAX, import paths."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    setup_env()
    from portbench.lib import harness
    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
