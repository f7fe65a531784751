"""Fleet supervision and elastic meshes of the port, with the cases of
``tests/test_elastic.py`` run against ``repro_torch.launch.elastic`` and
``repro_torch.launch.mesh``, and the port's decisions against the
reference's on one random heartbeat sequence.

The decision engine is transport-agnostic (time is driven directly), so
these tests cover exactly the logic that must be right when a pod dies
mid-run.  No tolerance: decisions and shapes are equal.
"""

import numpy as np
import pytest

from repro.launch import elastic as j_elastic
from repro.launch import mesh as j_mesh
from repro_torch.launch.elastic import (
    FleetDecision,
    FleetMonitor,
    elastic_restart_plan,
)
from repro_torch.launch.mesh import (
    Mesh,
    make_elastic_mesh,
    make_host_mesh,
    make_production_mesh,
)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make(n=8, monitor=FleetMonitor, **kw):
    clk = Clock()
    mon = monitor(n, now=clk, dead_after_s=60.0, straggle_factor=2.0,
                  straggle_patience=3, devices_per_worker=8, **kw)
    return mon, clk


def beat_all(mon, n, step, dt=1.0, skip=()):
    for i in range(n):
        if i not in skip:
            mon.heartbeat(i, step, dt)


def test_healthy_fleet_is_ok():
    mon, clk = make()
    for s in range(5):
        clk.t += 10
        beat_all(mon, 8, s)
        assert mon.assess().kind == "ok"


def test_missed_heartbeats_trigger_restart():
    mon, clk = make()
    beat_all(mon, 8, 0)
    clk.t += 61
    beat_all(mon, 8, 1, skip=(3, 5))
    d = mon.assess()
    assert d.kind == "restart"
    assert set(d.dead) == {3, 5}
    assert d.new_world_size == 6 * 8
    assert sorted(mon.alive_workers()) == [0, 1, 2, 4, 6, 7]
    # Dead workers stay dead on later assessments.
    clk.t += 1
    beat_all(mon, 8, 2, skip=(3, 5))
    assert mon.assess().kind == "ok"


def test_straggler_mitigated_then_evicted():
    mon, clk = make()
    kinds = []
    for s in range(4):
        clk.t += 5
        for i in range(8):
            mon.heartbeat(i, s, 10.0 if i == 2 else 1.0)
        d = mon.assess()
        kinds.append(d.kind)
        if d.kind == "mitigate":
            assert d.stragglers == (2,)
        if d.kind == "restart":
            assert 2 in d.dead
    # two soft strikes, then eviction; afterwards the fleet is healthy.
    assert kinds == ["mitigate", "mitigate", "restart", "ok"]


def test_straggler_strikes_reset_on_recovery():
    mon, clk = make()
    clk.t += 5
    for i in range(8):
        mon.heartbeat(i, 0, 10.0 if i == 2 else 1.0)
    assert mon.assess().kind == "mitigate"
    clk.t += 5
    beat_all(mon, 8, 1)          # worker 2 recovers
    assert mon.assess().kind == "ok"
    assert mon.workers[2].straggle_strikes == 0


@pytest.mark.parametrize("n,expect", [
    (256, ((16, 16), ("data", "model"))),
    (192, ((12, 16), ("data", "model"))),  # 192 % 16 == 0 -> model stays 16
    (100, ((25, 4), ("data", "model"))),
    (7, ((7, 1), ("data", "model"))),      # prime: pure DP
])
def test_elastic_restart_plan(n, expect):
    assert elastic_restart_plan(n) == expect
    mesh = make_elastic_mesh(n)
    assert (tuple(mesh.shape.values()), mesh.axis_names) == expect


def test_elastic_mesh_matches_plan():
    mesh = make_elastic_mesh(1, model=1)
    assert mesh.shape == {"data": 1, "model": 1}


def test_fleet_decisions_equal_the_references():
    """One random run of heartbeats, missed beats and slow steps drives the
    port's monitor and the reference's: every decision is the same."""
    rng = np.random.default_rng(11)
    ours, clk = make(n=6)
    theirs, jclk = make(n=6, monitor=j_elastic.FleetMonitor)
    for step in range(40):
        dt = float(rng.uniform(1, 30))
        clk.t += dt
        jclk.t += dt
        for w in range(6):
            if rng.random() < 0.1:
                continue                            # a missed heartbeat
            took = float(rng.choice([1.0, 1.1, 5.0], p=[0.7, 0.2, 0.1]))
            ours.heartbeat(w, step, took)
            theirs.heartbeat(w, step, took)
        a, b = ours.assess(), theirs.assess()
        assert isinstance(a, FleetDecision)
        assert (a.kind, a.dead, a.stragglers, a.new_world_size) == (
            b.kind, b.dead, b.stragglers, b.new_world_size), step
        assert ours.alive_workers() == theirs.alive_workers()


def test_meshes_have_the_references_shapes_and_need_no_group():
    """Building a mesh and asking its shape touches no process group; its
    DeviceMesh needs one of its size."""
    for ours, theirs in ((make_production_mesh(), ((16, 16),
                                                   ("data", "model"))),
                         (make_production_mesh(multi_pod=True),
                          ((2, 16, 16), ("pod", "data", "model")))):
        assert (tuple(ours.shape.values()), ours.axis_names) == theirs
    assert make_host_mesh().shape == dict(j_mesh.make_host_mesh().shape) \
        == {"data": 1, "model": 1}
    mesh = Mesh((2, 3), ("data", "model"))
    assert mesh.size == 6
    assert [mesh.coords(r) for r in (0, 4)] == [{"data": 0, "model": 0},
                                                {"data": 1, "model": 1}]
    for ask in (mesh.device_mesh, lambda: mesh.group(("data",))):
        with pytest.raises(RuntimeError, match="process group"):
            ask()
    assert Mesh((1, 1), ("data", "model")).group(("data", "model")) is None
