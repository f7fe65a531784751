"""Phase spans and step counters of the port's serving engine
(``repro_torch.serving.spans``).

The f32 smoke config serves an oversubscribed pool in each fault mode, so
steps preempt, compact, fault in and hit the prefix cache.  Every
``step()`` call leaves one record; the spans nest as the engine's phases
do, under ``torch.profiler`` as host events; the ``EngineStats`` timers
are the sums of their spans; the OutOfMemory compaction counts are the
managers' own.
"""

import dataclasses
from collections import deque

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PoolGeometry
from repro_torch.serving import spans
from repro_torch.serving.engine import Request, ServingEngine

MODES = ("sync", "async", "fused")
GEO = dict(page_tokens=8, frame_pages=4, compact_threshold=0.4)
# EngineStats timer field -> the span that feeds it.
TIMERS = {"wall_s": "serve.step", "prefill_s": "serve.prefill_fwd",
          "decode_s": "serve.decode", "h2d_s": "serve.h2d",
          "d2h_s": "serve.d2h", "prefix_h2d_s": "serve.prefix_h2d"}
# Each span -> the spans it may sit directly under (None: none).
PARENTS = {
    "serve.step": {None},
    **{name: {"serve.step"} for name in (
        "serve.host_tier", "serve.admit", "serve.grow", "serve.fault_in",
        "serve.pack", "serve.prefetch", "serve.decode", "serve.settle",
        "serve.retire", "serve.pool_stats")},
    "serve.alloc": {"serve.admit"},
    "serve.preempt": {"serve.admit", "serve.alloc", "serve.grow"},
    "serve.d2h": {"serve.preempt", "serve.park"},
    "serve.prefill": {"serve.admit"},
    "serve.prefill_fwd": {"serve.prefill"},
    "serve.prefix_h2d": {"serve.prefill"},
    "serve.compact": {"serve.step", "serve.admit", "serve.preempt",
                      "serve.prefill", "serve.park"},
    "serve.h2d": {"serve.fault_in", "serve.pack", "serve.settle"},
    # The page ring lands each chunk inside the transfer's serve.h2d; the
    # fused path lands its stage after decode.
    "serve.land": {"serve.h2d", "serve.settle"},
    "serve.park": {"serve.retire"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_log(monkeypatch):
    log = deque(maxlen=spans.LOG_STEPS)
    monkeypatch.setattr(spans, "_log", log)
    return log


def make_engine(mode):
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    eng = ServingEngine(cfg, geometry=PoolGeometry(**GEO), max_batch=6,
                        max_seq=96, oversubscription=2.0, fault_mode=mode,
                        device="cpu")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    for i in range(10):
        T = int(rng.integers(24, 56))
        prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
        if i % 2:
            prompt[:16] = shared            # two cached pages once parked
        eng.submit(Request(rid=i, tenant=i % 3, prompt=prompt,
                           max_new=int(rng.integers(24, 40)),
                           priority=i % 3))
    return eng


def serve(mode):
    """Steps the engine to the end, one call at a time; returns it, the
    records each call added, and the log."""
    log = deque(maxlen=spans.LOG_STEPS)
    saved, spans._log = spans._log, log
    try:
        eng = make_engine(mode)
        added = []
        while eng.queue or eng.active or eng.preempted:
            n = len(log)
            eng.step()
            added.append(len(log) - n)
    finally:
        spans._log = saved
    return eng, added, list(log)


@pytest.fixture(scope="module", params=MODES)
def served(request):
    return request.param, *serve(request.param)


def test_the_run_preempts_faults_in_and_hits_the_cache(served):
    _mode, eng, _added, _log = served
    s = eng.stats
    assert s.swaps_out > 0 and s.faults > 0 and s.prefix_hits > 0
    assert s.d2h_s > 0 and s.h2d_s > 0 and s.prefix_h2d_s > 0


def test_every_step_call_appends_one_record(served):
    _mode, eng, added, log = served
    assert added and set(added) == {1}
    assert len(log) == len(added)
    assert {r["engine_id"] for r in log} == {eng.engine_id}


def test_depth1_spans_fit_in_the_step(served):
    _mode, _eng, _added, log = served
    for r in log:
        assert set(r["depth1"]) <= {n for n, p in PARENTS.items()
                                    if "serve.step" in p}
        assert sum(r["depth1"].values()) <= r["spans"]["serve.step"]


def test_timer_fields_are_the_sums_of_their_spans(served):
    _mode, eng, _added, log = served
    for field, name in TIMERS.items():
        total = sum(r["spans"].get(name, 0.0) for r in log)
        assert total > 0, name
        assert getattr(eng.stats, field) == pytest.approx(total, rel=1e-9)
    hit_cold = sum(r["spans"]["serve.prefill"] for r in log
                   if "serve.prefill" in r["spans"]) * 1e6
    assert eng.stats.admit_hit_us + eng.stats.admit_cold_us == \
        pytest.approx(hit_cold, rel=1e-9)


def test_oom_counters_are_the_managers_own(served):
    _mode, eng, _added, log = served
    got = sum(r["counters"]["oom_compactions"] for r in log)
    assert got == sum(m.oom_compactions for m in eng.cache.mgrs) > 0
    refused = sum(r["counters"]["oom_refusals"] for r in log)
    assert refused == sum(m.oom_refusals for m in eng.cache.mgrs) <= got
    tries = sum(r["counters"].get("admit_tries", 0) for r in log)
    assert tries >= sum(r["counters"].get("admit_refused", 0) for r in log)
    assert tries >= 10


def test_window_sums_the_last_records(fresh_log, served):
    _mode, _eng, _added, log = served
    fresh_log.extend(log)
    assert spans.window(len(log) + 1) is None
    assert spans.window(0) is None
    w = spans.window(3)
    assert w["steps"] == 3
    assert w["spans"]["serve.step"] == pytest.approx(
        sum(r["spans"]["serve.step"] for r in log[-3:]))
    assert w["records_with"]["oom_compactions"] == 3
    whole = spans.window(len(log))
    assert whole["counters"]["coalesced_fraction"] == pytest.approx(
        sum(r["counters"].get("coalesced_fraction", 0.0) for r in log))


def test_a_crashed_or_idle_engine_step_still_leaves_a_record(fresh_log):
    eng = make_engine("async")
    eng.queue.clear()
    assert eng.step() is False              # nothing to do
    eng.alive = False
    assert eng.step() is False              # crashed
    assert len(fresh_log) == 2
    assert "serve.admit" in fresh_log[0]["spans"]
    assert fresh_log[1]["spans"] == {}


def _serve_span_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("serve."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("mode", MODES)
def test_spans_are_host_events_nested_as_declared(mode, fresh_log):
    eng = make_engine(mode)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run_until_drained()
    seen = {}
    for ev in prof.events():
        if ev.name.startswith("serve."):
            assert ev.name in PARENTS, ev.name
            seen.setdefault(ev.name, set()).add(_serve_span_parent(ev))
    for name, parents in seen.items():
        assert parents <= PARENTS[name], (name, parents)
    must = {"serve.step", "serve.admit", "serve.alloc", "serve.preempt",
            "serve.d2h", "serve.prefill", "serve.prefill_fwd",
            "serve.prefix_h2d", "serve.grow", "serve.fault_in",
            "serve.h2d", "serve.pack", "serve.decode", "serve.retire",
            "serve.park", "serve.pool_stats", "serve.compact",
            "serve.host_tier"}
    if mode != "sync":
        must |= {"serve.prefetch"}
    if mode == "fused":
        must |= {"serve.settle"}
    else:
        must |= {"serve.land"}
    assert must <= set(seen), must - set(seen)
    # One serve.step event a call that did work, as in the log.
    steps = sum(1 for r in fresh_log if "serve.step" in r["spans"])
    assert sum(1 for ev in prof.events() if ev.name == "serve.step") == steps


def test_no_profiler_range_is_entered_with_the_profiler_off(monkeypatch,
                                                            fresh_log):
    entered = []

    def trap(name):
        entered.append(name)
        raise AssertionError(f"profiler range {name} entered")

    monkeypatch.setattr(spans, "_profiler_range", trap)
    monkeypatch.setattr(torch.profiler, "record_function", trap)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", trap)
    eng = make_engine("async")
    for _ in range(8):
        eng.step()
    assert not entered and len(fresh_log) == 8
    assert eng.stats.swaps_out + eng.stats.prefill_tokens > 0


def test_spans_outside_a_step_feed_their_field_only(fresh_log):
    """A span with no step open (the public ``preempt()``) still times
    its field and records nothing."""
    eng = make_engine("async")
    eng.step()
    d2h = eng.stats.d2h_s
    assert eng.preempt(eng.active[0].rid)
    assert eng.stats.d2h_s > d2h
    assert len(fresh_log) == 1
