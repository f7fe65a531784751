"""One run of one cell: checks the card, runs the cell's driver, reads the
metrics and prints the result line.

``--trace 0`` prints the cell's end-to-end metrics (the driver's readings
of the same name, and ``memory_peak_gib``: the card allocator's peak over
set-up and window, absent off the card), ``--trace 1`` its per-layer
metrics, each read by ``portbench/metrics/<name>.py`` or, where
that file is absent, by the reader of its quantity, the name without its
last dotted part (``engine.step_ms.batch`` by ``engine.step_ms.py``): a
``read(readings)`` that returns a number or None; None leaves the metric
out of the line.  The numbers compared for ``correct`` are printed beside
their limits as the last lines of standard error and, under ``checks``,
as the last key of the result line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from typing import Optional

from portbench.lib import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader_path(name: str):
    path = spec.BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = spec.BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def reader(name: str):
    path = reader_path(name)
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def driver(cell: spec.Cell):
    return importlib.import_module(
        f"portbench.lib.drive_{cell.cell['driver']}")


def metrics_of(cell: spec.Cell, r: dict, trace: bool) -> dict:
    out = {}
    if not trace:
        peak = r.get("memory_peak_bytes")
        readings = {**r, "memory_peak_gib": peak / 2 ** 30 if peak else None}
        for m in cell.end_to_end:
            v = readings.get(m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = reader(m["name"])(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(workload: str, seed: int, seconds: int, trace: bool,
         t0: float) -> int:
    cell = spec.load(workload)
    import torch
    chips = next(w["chips"] for w in spec.load_json(
        spec.ROOT / "BENCHMARK.json")["workloads"] if w["name"] == workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    r = driver(cell).run(cell, seed, seconds, trace, t0, device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    check = r["check"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": r["memory_peak_bytes"],
              "power_limit": power_limit()}
    line = {"correct": check["correct"], "attempted": r["attempted"],
            "failed": r["failed"], "metrics": metrics_of(cell, r, trace),
            "device": device}
    if trace:
        t = r.get("trace")
        if t is None:
            print("portbench: the traced slice recorded nothing",
                  file=sys.stderr)
            return 4
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = t["breakdown"]
    print(json.dumps({"setup_s": r["setup_s"], "window_s": r["window_s"],
                      "out_tok_s": r.get("out_tok_s"),
                      "engine_steps": r.get("engine_steps"),
                      "admitted": r.get("admitted"),
                      "finished": r.get("finished"),
                      "stats": r.get("stats"), "info": check["info"],
                      "numbers": check["numbers"]}),
          file=sys.stderr)
    compared = {k: {"value": v, "limit": lim}
                for k, (v, lim) in check["compared"].items()}
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    line["checks"] = compared
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
