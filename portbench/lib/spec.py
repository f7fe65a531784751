"""Finds a cell's files by the names in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix.  Its files:

* ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (``portbench/configs/<config>.json``), which names its plain reference
  (``portbench/refs/<reference>.py``) and the port's architecture id;
* ``portbench/traffic/<traffic>.json``: the mix's parameters;
* ``portbench/cells/<workload>.json``: the engine or trainer settings of
  the cell, its correctness limits and the ``driver``
  (``portbench/lib/drive_<driver>.py``) that runs it;
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric, or
  one per quantity that its cells' metrics share
  (``metrics/engine.step_ms.py`` reads ``engine.step_ms.<cells>``).

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict           # the configuration's file
    traffic: dict        # the mix's file
    cell: dict           # the cell's file
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def ref(self):
        return reference(self.conf)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reference(conf: dict):
    return importlib.import_module(f"portbench.refs.{conf['reference']}")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell's files, by the names in ``bench`` (``BENCHMARK.json``)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    return Cell(name=workload, conf=load_json(ROOT / config["file"]),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                cell=load_json(BENCH / "cells" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)
