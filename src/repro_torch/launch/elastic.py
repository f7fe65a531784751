"""Fleet supervision: heartbeats, straggler mitigation, elastic restart.

A copy of the reference's ``launch/elastic.py`` (it holds no JAX).

On a real multi-pod deployment each host runs a ``WorkerAgent`` (heartbeat
writer) and rank 0 runs the ``FleetMonitor``.  Policy:

  * missed heartbeat > ``dead_after_s``      → worker DEAD → elastic
    restart: rebuild the mesh from survivors (``make_elastic_mesh``),
    restore the newest complete checkpoint re-sharded onto it;
  * step time > ``straggle_factor`` × median → worker STRAGGLING → first
    soft-mitigate (re-dispatch its input shard / drop to best-effort
    collectives), escalate to DEAD after ``straggle_patience`` repeats.

The control logic is deliberately transport-agnostic (heartbeats are a
dict the tests drive directly; production wires it to GCS/etcd), so the
decision engine itself is unit-tested — the part that actually must be
correct when a pod vanishes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float
    last_step: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)
    straggle_strikes: int = 0
    alive: bool = True


@dataclasses.dataclass
class FleetDecision:
    kind: str                 # 'ok' | 'mitigate' | 'restart'
    dead: Tuple[int, ...] = ()
    stragglers: Tuple[int, ...] = ()
    new_world_size: Optional[int] = None


class FleetMonitor:
    def __init__(self, n_workers: int, *, dead_after_s: float = 60.0,
                 straggle_factor: float = 2.0, straggle_patience: int = 3,
                 devices_per_worker: int = 8,
                 now: Callable[[], float] = time.monotonic):
        self.now = now
        self.dead_after_s = dead_after_s
        self.straggle_factor = straggle_factor
        self.straggle_patience = straggle_patience
        self.devices_per_worker = devices_per_worker
        t = now()
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(last_heartbeat=t) for i in range(n_workers)}

    # ------------------------------------------------------------ inputs

    def heartbeat(self, worker: int, step: int, step_time_s: float):
        w = self.workers[worker]
        w.last_heartbeat = self.now()
        w.last_step = step
        w.step_times.append(step_time_s)
        if len(w.step_times) > 20:
            w.step_times.pop(0)

    # ------------------------------------------------------------ policy

    def _median_step(self) -> float:
        times = sorted(
            t for w in self.workers.values() if w.alive and w.step_times
            for t in w.step_times[-5:])
        return times[len(times) // 2] if times else 0.0

    def assess(self) -> FleetDecision:
        t = self.now()
        dead, stragglers = [], []
        med = self._median_step()
        for i, w in self.workers.items():
            if not w.alive:
                continue
            if t - w.last_heartbeat > self.dead_after_s:
                w.alive = False
                dead.append(i)
                continue
            if med > 0 and w.step_times and \
                    w.step_times[-1] > self.straggle_factor * med:
                w.straggle_strikes += 1
                if w.straggle_strikes >= self.straggle_patience:
                    w.alive = False
                    dead.append(i)
                else:
                    stragglers.append(i)
            else:
                w.straggle_strikes = 0
        if dead:
            alive = sum(w.alive for w in self.workers.values())
            return FleetDecision(
                "restart", dead=tuple(dead), stragglers=tuple(stragglers),
                new_world_size=alive * self.devices_per_worker)
        if stragglers:
            return FleetDecision("mitigate", stragglers=tuple(stragglers))
        return FleetDecision("ok")

    def alive_workers(self) -> List[int]:
        return [i for i, w in self.workers.items() if w.alive]


def elastic_restart_plan(n_devices_left: int, *, model_axis: int = 16):
    """What a restart does: new mesh + which checkpoint artifacts to load.

    Returns (mesh_shape, mesh_axes).  Training resumes from the newest
    complete checkpoint; ``repro_torch.train.checkpoint.restore`` re-shards onto
    the new mesh (full logical arrays → any device count).
    """
    m = model_axis
    while m > 1 and n_devices_left % m:
        m //= 2
    return (n_devices_left // m, m), ("data", "model")
