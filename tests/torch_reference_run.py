"""The reference's process beside the port's ranks in the multi-process
tests, and how long any of their subprocesses may take.

``tests/test_torch_train_dist.py``, ``test_torch_train_tp.py``,
``test_torch_serve_mesh.py`` and ``test_torch_serve_mesh_families.py``
each run the reference once, in a process of its own on forced host
devices, while the port's gloo ranks (``repro_torch.launch.spawn``) run,
and both share the machine with the rest of the tier-1 suite on other
pytest workers.  How long they take depends on that load, so no wait is
a bare number of seconds counted from when a test asks: the reference's
is counted from the process's own start, and every wait (the reference's,
a rank spawn's ``timeout``) may last :data:`WAIT_SECONDS`, half of the
suite's whole time limit.  A loaded machine then slows a test down
without failing it, while a process that hangs still fails its test well
before the suite is cut.  The reference runs on one intra-op thread
(XLA's CPU flags), as the port's ranks do (``torch.set_num_threads(1)``),
so that neither oversubscribes the cores the other workers use.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The tier-1 suite's whole time limit (its run is cut at 1470 s), and the
# longest any one wait on a test's subprocess may last.
SUITE_SECONDS = 1470
WAIT_SECONDS = SUITE_SECONDS // 2

# XLA's backend optimisation level 0 compiles the references' steps in
# about 60 % of the time; their results move by ~2e-7 relative, far inside
# every tolerance of these files.
XLA_FAST = ("--xla_backend_optimization_level=0 "
            "--xla_llvm_disable_expensive_passes=true")
XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")


class ReferenceRun:
    """``script`` (Python source) run as ``python -c script *args`` on
    ``devices`` forced host devices, started at once, its output in
    ``out_dir / reference.log``.  :meth:`wait` waits for it at most
    :data:`WAIT_SECONDS` from its start and fails with the log's tail if
    it is still running or exited non-zero."""

    def __init__(self, script, args, out_dir, devices=4, fast=True):
        flags = [f"--xla_force_host_platform_device_count={devices}",
                 XLA_ONE_THREAD] + ([XLA_FAST] if fast else [])
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(flags))
        self.log = open(Path(out_dir) / "reference.log", "w+")
        self.start = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, *map(str, args)], env=env,
            cwd=str(ROOT), stdout=self.log, stderr=subprocess.STDOUT)

    def _tail(self) -> str:
        self.log.seek(0)
        return self.log.read()[-4000:]

    def wait(self) -> None:
        left = self.start + WAIT_SECONDS - time.monotonic()
        try:
            self.proc.wait(timeout=max(left, 0.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(
                f"the reference's run outlived {WAIT_SECONDS}s from its "
                f"start\n{self._tail()}") from None
        assert self.proc.returncode == 0, (
            f"the reference's run exited {self.proc.returncode} after "
            f"{time.monotonic() - self.start:.0f}s\n{self._tail()}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()
