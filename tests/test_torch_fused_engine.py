"""The port's ServingEngine in fused fault-in vs the reference's.

Fused decode reads this step's staged pages in the attention kernel
instead of waiting for them (on the CPU: the kernel's plain version).  The
helpers, weights and workloads are tests/test_torch_async_engine.py's:
f32 smoke config on bridged weights, 2x oversubscribed, a fixed modeled
decode window, the reference with ``prefix_cache=False``.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import MLAConfig
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from test_torch_async_engine import (  # noqa: F401  (fixtures)
    GEO_KW,
    WINDOW_US,
    WORKLOADS,
    _engine,
    _one_torch_thread,
    _requests,
    check_matches_reference,
    weights,
)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_fused_engine_matches_reference(workload, weights):
    check_matches_reference("fused", workload, weights)


def _resume_run(mode, weights):
    """test_fused_decode.py:246: hold a request swapped out until its
    pages are cold, then release; its first decode step starts with every
    page missing."""
    cfg, eng = _engine("torch", mode, weights, max_batch=3,
                       window=None if mode == "sync" else WINDOW_US)
    rng = np.random.default_rng(3)
    reqs = [TRequest(rid=i, tenant=i, max_new=mn,
                     prompt=rng.integers(0, cfg.vocab_size, T)
                     .astype(np.int32))
            for i, (T, mn) in enumerate([(64, 16), (40, 28), (40, 28)])]
    for r in reqs:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    assert eng.preempt(0, hold=True)
    for _ in range(6):
        eng.step()
    assert eng.release(0)
    eng.run_until_drained(max_steps=2000)
    assert all(r.done for r in reqs)
    eng.cache.check_invariants()
    return eng, {r.rid: list(r.out) for r in reqs}


def test_fused_zero_resident_resume_step(weights):
    _, sync = _resume_run("sync", weights)
    eng, fused = _resume_run("fused", weights)
    assert fused == sync
    s = eng.stats
    assert s.faults > 0 and s.fused_ready_pages + s.fused_drained_pages > 0
    assert s.h2d_bytes == s.faults * eng.page_bytes


def test_fused_midrun_preemption_keeps_tokens(weights):
    """test_fused_decode.py:278: preempt a live request mid-run under fused
    mode (its staged pages settle before the gather) and resume."""
    outs = {}
    for mode in ("sync", "fused"):
        cfg, eng = _engine("torch", mode, weights,
                           window=None if mode == "sync" else WINDOW_US)
        reqs = _requests(TRequest, cfg.vocab_size, 6, seed=4)
        for r in reqs:
            eng.submit(r)
        for _ in range(4):
            eng.step()
        victim = next(r.rid for r in reqs if not r.done)
        assert eng.preempt(victim)
        eng.run_until_drained(max_steps=2000)
        assert all(r.done for r in reqs)
        eng.cache.check_invariants()
        assert eng.host.request_pages() == 0
        outs[mode] = {r.rid: list(r.out) for r in reqs}
    assert outs["fused"] == outs["sync"]


def test_fused_rejects_mla_configs():
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), mla=MLAConfig())
    with pytest.raises(ValueError, match="dense-attention"):
        TEngine(cfg, geometry=TGeo(**GEO_KW), max_batch=2, max_seq=32,
                device="cpu", fault_mode="fused")


def test_chip_smoke_main_path_in_three_modes_on_cpu():
    """chip_smoke.py's main path rehearsed at smoke width on the CPU: each
    fault mode passes the run's checks (async makes prefetch hits, fused
    reads staged pages in decode), and the three emit identical tokens.
    Scheduling depends on token counts only, so the full-width run on the
    card does the same."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    cfg = t_smoke("qwen2.5-3b")
    tokens = {}
    for mode in cs.MODES:
        eng, stream, events, counts, _wall = cs.serve_mode(cfg, mode,
                                                           device="cpu")
        cs.check_mode_run(cfg, mode, eng, stream, events, counts)
        assert not any(counts.values())      # plain versions on the CPU
        tokens[mode] = {r.rid: list(r.out) for _, r in stream}
    assert tokens["async"] == tokens["sync"] == tokens["fused"]
