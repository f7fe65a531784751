"""Run a function on D ranks, each in its own process, and collect what
each returns.

``run_ranks("pkg.mod:fn", world, device=..., args=...)`` starts ``world``
interpreters (``python -m repro_torch.launch.spawn``).  Each initialises
the default process group through a ``FileStore`` in a fresh temporary
directory (no port to pick; NCCL on ``cuda:rank``, gloo on the CPU, or
with ``backend="gloo"`` and ``device="cuda"`` gloo ranks sharing
``cuda:0``; see :func:`~repro_torch.launch.mesh.init_distributed`), calls
``fn(*args)``, saves the result (nested lists / dicts of tensors, numbers
and strings) and tears the group down.  A rank that fails or outlives
``timeout`` fails the caller: every rank is then killed and the error
carries the failed ranks' output.  ``paths`` are put in front of the
children's ``PYTHONPATH`` (beside the port's own source directory), so
that ``fn`` may live outside the package (tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch

_SRC = str(Path(__file__).resolve().parents[2])


def run_ranks(target: str, world: int, *, device: str = "cpu",
              args: Sequence[Any] = (), timeout: float = 120.0,
              paths: Sequence[str] = (), env=None,
              backend: Optional[str] = None) -> List[Any]:
    """``target`` ("module:function") on ranks 0 .. world - 1; returns the
    ranks' results in rank order.  ``args`` must be JSON-serialisable."""
    tmp = tempfile.mkdtemp(prefix="ranks_")
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [*map(str, paths), _SRC, *filter(None, [env.get("PYTHONPATH")])])
    procs, logs = [], []
    try:
        for r in range(world):
            spec = dict(target=target, rank=r, world=world, device=device,
                        backend=backend, args=list(args), tmp=tmp)
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.spawn",
                 json.dumps(spec)], env=dict(env, LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll()]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            tails = []
            for r in bad:
                logs[r].seek(0)
                tails.append(f"--- rank {r} (exit {procs[r].returncode}) "
                             f"---\n{logs[r].read()[-4000:]}")
            raise RuntimeError(f"{target} on {world} ranks: rank(s) {bad} "
                               f"failed or timed out after {timeout}s\n"
                               + "\n".join(tails))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child(spec) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    init_distributed(spec["device"], backend=spec["backend"],
                     init_method=f"file://{spec['tmp']}/rendezvous",
                     rank=spec["rank"], world_size=spec["world"])
    try:
        module, _, name = spec["target"].partition(":")
        result = getattr(importlib.import_module(module), name)(*spec["args"])
        torch.save(result, os.path.join(spec["tmp"], f"rank{spec['rank']}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(json.loads(sys.argv[1]))
