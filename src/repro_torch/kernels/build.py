"""Builds the CUDA sources under ``repro_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` (all started
together) for ``sm_90a`` into a shared library with a plain C interface,
loaded through ``ctypes``.  Libraries land in ``<repo>/build/kernels/<key>/``,
where ``<key>`` hashes the sources and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built at import time:
the first kernel launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {home}/bin): the CUDA "
            f"kernels can only be built where the CUDA toolkit is installed")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns name → .so path.

    Records the wall seconds and each source's ``ptxas`` report in
    :data:`BUILD_INFO`.
    """
    out_dir = BUILD_ROOT / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources}
    todo = [s for s in sources if not libs[s.stem].exists()]
    t0 = time.perf_counter()
    procs = []
    if todo:
        nvcc = _nvcc()
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    reports = {}
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        reports[src.stem] = log
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, libs[src.stem])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=len(todo),
                      directory=str(out_dir), ptxas=reports)
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        for stem, path in paths.items():
            _LIBS.setdefault(stem, ctypes.CDLL(str(path)))
        lib = _LIBS[name]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
