"""Nothing the benchmark runs or imports is JAX or the JAX package: the
top-level module name is compared whole, so ``repro_torch`` passes and
``repro`` does not.  Nothing in ``portbench/`` reads the reference's
benchmark files."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.lib import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.run
import portbench.tools.readings, portbench.tools.spread
from portbench.lib import harness, spec, drive_serve
for pkg in ("portbench.lib", "portbench.refs"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(pkg + "." + info.name)
for path in sorted((spec.BENCH / "metrics").glob("*.py")):
    harness.reader(path.stem)
# The program modules the serving driver reaches.
import repro_torch.serving.engine, repro_torch.models.lm
import repro_torch.kernels.build, repro_torch.configs.base
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_forbidden_names_are_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "reprox.sub", sys)
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.serving", sys)
    assert "repro" in harness.forbidden_modules()


def test_imports_load_no_jax_and_no_reference_package():
    code = IMPORT_ALL.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    names = set(eval(out.strip().splitlines()[-1]))
    assert "repro_torch" in names and "portbench" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_sources_import_no_jax_and_no_reference_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(harness.FORBIDDEN), (path, tops)


def test_no_reads_of_the_reference_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        assert "BENCH_serving" not in text, path
        assert "benchmarks/" not in text, path
