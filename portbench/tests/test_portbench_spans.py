"""The six readers of the engine's step log, against a hand-made log; each
reads nothing (None) where the log holds fewer records than the window's
steps, where the window ran none, and where the program has no log."""

import sys
from collections import deque

import pytest

from portbench.lib import harness, spec
from repro_torch.serving import spans

# Three steps of one engine: 0.1 + 0.3 + 0.2 s of serve.step.
LOG = [
    {"engine_id": 0,
     "spans": {"serve.step": 0.1, "serve.admit": 0.06, "serve.alloc": 0.02,
               "serve.preempt": 0.01, "serve.decode": 0.03},
     "depth1": {"serve.admit": 0.06, "serve.decode": 0.03},
     "counters": {"oom_compactions": 2, "oom_refusals": 1,
                  "coalesced_fraction": 0.5}},
    {"engine_id": 0,
     "spans": {"serve.step": 0.3, "serve.admit": 0.12,
               "serve.fault_in": 0.02, "serve.decode": 0.15},
     "depth1": {"serve.admit": 0.12, "serve.fault_in": 0.02,
                "serve.decode": 0.15},
     "counters": {"oom_compactions": 4, "oom_refusals": 0,
                  "coalesced_fraction": 0.75}},
    {"engine_id": 0,
     "spans": {"serve.step": 0.2, "serve.admit": 0.12,
               "serve.preempt": 0.05},
     "depth1": {"serve.admit": 0.12},
     "counters": {"oom_compactions": 0, "oom_refusals": 0}},
]
# Over all three steps (0.6 s of serve.step, 0.5 s in depth-1 spans).
EXPECTED = {
    "engine.admit_ms.batch": 100.0,             # 0.30 s / 3 steps
    "engine.unspanned_share.batch": 100 / 6,    # 1 - 0.5 / 0.6
    "paging.fault_in_ms.batch": 20 / 3,         # 0.02 s / 3
    "manager.preempt_ms.batch": 20.0,           # 0.06 s / 3
    "manager.oom_compactions_per_step.batch": 2.0,
    "manager.coalesced_share.batch": 62.5,      # (0.5 + 0.75) / 2 steps
}


@pytest.fixture
def log(monkeypatch):
    held = deque([{"engine_id": 1, "spans": {"serve.step": 9.0},
                   "depth1": {}, "counters": {}}] + LOG,
                 maxlen=spans.LOG_STEPS)
    monkeypatch.setattr(spans, "_log", held)
    return held


def test_the_six_metrics_are_in_the_benchmark():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert m["workloads"] == ["qwen2.5-3b.oversub"]
        assert m["moves"] == "memory_peak_gib"
        assert harness.reader_path(name).exists()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_hand_worked(name, log):
    # The window is the last engine_steps records: the older one is out.
    got = harness.reader(name)({"engine_steps": 3})
    assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("steps", [0, 5])
def test_reader_of_a_window_the_log_cannot_hold(name, steps, log):
    assert harness.reader(name)({"engine_steps": steps}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_of_a_program_without_the_log(name, log, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.serving.spans", None)
    assert harness.reader(name)({"engine_steps": 3}) is None


def test_steps_with_no_coalesced_reading_read_nothing(log):
    """The last step (an early return) has no pool reading: a window of it
    alone has no coalesced share, and no fault-in reads 0 ms."""
    r = {"engine_steps": 1}
    assert harness.reader("manager.coalesced_share.batch")(r) is None
    assert harness.reader("manager.preempt_ms.batch")(r) == \
        pytest.approx(50.0)
    assert harness.reader("paging.fault_in_ms.batch")(r) == 0.0
