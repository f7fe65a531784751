"""The PyTorch port stands alone: no JAX, nothing of the reference package.

Every ``repro_torch`` module is imported in a fresh interpreter with
``jax`` blocked; afterwards no ``jax`` or ``repro`` module may be loaded.
The sources of the port and of ``chip_smoke.py`` must not import either.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or (m.startswith("jax") and sys.modules[m] is not None))
print(len(names), "modules")
print("BAD", bad)
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 26, out.stdout
    assert out.stdout.strip().endswith("BAD []"), out.stdout


_NAMED = r"""
import sys
sys.modules["jax"] = None
from repro_torch.serving.dma import AsyncDMAEngine, Prefetcher, StagingBuffer
from repro_torch.serving.engine import ServingEngine
from repro_torch.kernels.ops import KERNELS, fused_paged_attention_kernel
assert "paged_attention.fused" in KERNELS
assert ServingEngine.__init__.__kwdefaults__["fault_mode"] == "async"
print("BAD", sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.startswith("jax") and sys.modules[m] is not None)))
"""


def test_async_pipeline_and_fused_kernel_import_without_jax():
    """The modules this slice adds or extends, imported by name."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NAMED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_sources_never_import_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
