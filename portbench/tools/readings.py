"""Correctness readings of a serving cell over many seeds, in one process.

    python3 portbench/tools/readings.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--control]

Each seed is a whole run of the cell at its own size (set-up, a window of
``--seconds``, the comparison); it prints one JSON line with the
program's numbers (``gap_max``, ``gap_mean``) and verdict and, with
``--control``, the precision control's (the reference in fp8 at the same
positions, put through the same comparison with the cell's limits).
These readings set a cell's limit (``PERF.md``).  Lines also go to
``chiprun_out/readings-<cell>.jsonl``.  Needs the cell's CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from portbench.run import ROOT, setup_env  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    setup_env()
    from portbench.lib import harness, spec
    cell = spec.load(args.workload)
    out = ROOT / "chiprun_out" / f"readings-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.driver(cell).run(cell, seed, args.seconds, False, t0,
                                     control=args.control)
        c = r["check"]
        line = {"workload": args.workload, "seed": seed, **c["numbers"],
                "correct": c["correct"],
                "control": c["control"] and {
                    **c["control"]["numbers"],
                    "correct": c["control"]["correct"]},
                **c["info"], "setup_s": r["setup_s"],
                "window_s": r["window_s"], "out_tok_s": r["out_tok_s"],
                "engine_steps": r["engine_steps"],
                "admitted": r["admitted"], "finished": r["finished"],
                "stats": r["stats"]}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
