"""On the card: one short run of each cell through ``portbench/run.py``
(skips without a CUDA device)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", workload, "--seed", "3",
                        "--seconds", "10", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
