"""The run-to-run spread of a cell, as its bounds are set from.

    python3 portbench/tools/spread.py --workload <cell> --seeds a b c ...
        [--sets 2] [--trace-seeds x y z]

Runs ``portbench/run.py`` once per seed in each set (the same seeds in
every set, each run its own process, in order), then once per trace seed
with ``--trace 1``, and prints each run's result line and, per set and
metric, the median and the spread: the distance between the first and
third quartile (``statistics.quantiles(values, n=4)``) over the median.
The window's ``out_tok_s``, which the cell reads per layer, is taken from
each untraced run's summary on standard error and spread the same way.
Lines also go to ``chiprun_out/spread-<cell>.jsonl``.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run(workload, seed, seconds, trace):
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True, cwd=ROOT)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
    summary = [json.loads(s) for s in p.stderr.splitlines()
               if s.startswith('{"setup_s"')]
    return {"rc": p.returncode, "seed": seed, "trace": trace,
            "result": json.loads(line) if p.returncode == 0 else None,
            "out_tok_s": summary[-1].get("out_tok_s") if summary else None,
            "stderr_tail": p.stderr[-1500:]}


def spread(vals):
    med = statistics.median(vals)
    q = statistics.quantiles(vals, n=4) if len(vals) > 1 else [med] * 3
    return med, (q[2] - q[0]) / med if med else None


def trimmed(vals):
    """The values without the one farthest from their median."""
    med = statistics.median(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    return vals[:far] + vals[far + 1:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=int, default=None)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    out = ROOT / "chiprun_out" / f"spread-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in args.seeds:
            r = run(args.workload, seed, seconds, 0)
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(r) + "\n")
        sets.append(runs)
    for seed in args.trace_seeds:
        r = run(args.workload, seed, seconds, 1)
        print(json.dumps(r), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(r) + "\n")
    per_metric = {}
    for k, runs in enumerate(sets):
        ok = [r["result"] for r in runs if r["result"]]
        for r, run_ in zip(ok, [r for r in runs if r["result"]]):
            if run_["out_tok_s"] is not None:
                r["metrics"].setdefault("out_tok_s", {
                    "value": run_["out_tok_s"]})
        for name in sorted({m for r in ok for m in r["metrics"]}):
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            med, sp = spread(vals)
            per_metric.setdefault(name, []).append(vals)
            print(json.dumps({"set": k, "metric": name, "median": med,
                              "spread": sp, "values": vals}), flush=True)
        print(json.dumps({"set": k, "correct": [r["correct"] for r in ok],
                          "checks": [r["checks"] for r in ok],
                          "failed_runs": len(runs) - len(ok)}), flush=True)
    for name, per_set in per_metric.items():
        if len(per_set) < 2 or min(map(len, per_set)) < 3:
            continue
        tight = statistics.mean(spread(trimmed(v))[1] for v in per_set)
        print(json.dumps({"metric": name, "trimmed_spread": tight,
                          "all_runs_spread": spread(sum(per_set, []))[1]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
