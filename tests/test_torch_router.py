"""The port's request router (``serving/router.py``) and the engine's
pre-staging hooks against the reference's, on the scenarios of
tests/test_router_cost.py (f32 smoke config, bridged weights, modeled
costs with ``decode_window_us`` set).

* ``engine_cost_us`` of every engine equals the reference's after every
  router step of a mixed workload (queued, active, preempted and spilled
  work, with the translation term on), and so do the dispatch choices.
* Pre-staging: tokens identical with it on and off; the pre-stage, hit,
  waste, cancel and refund counters equal the reference's, through a
  queued steal and through a crash that re-dispatches a pre-staged
  request exactly once.
* Queued-steal hysteresis and pinning hold in the port as in the
  reference.
"""

import numpy as np
import pytest
import torch

from test_torch_cluster_helpers import (PACKAGES, PTOK, assert_same_run,
                                        cluster_state, make_cluster, prompt,
                                        request_cls)
from test_torch_parity_helpers import bridged

pytestmark = pytest.mark.router

VOCAB = bridged("qwen2.5-3b")[0].vocab_size


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(package, n_engines=1, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq", 128)
    kw.setdefault("seed", 0)
    kw.setdefault("migrate", False)
    kw.setdefault("decode_window_us", 1000.0)
    return make_cluster(package, n_engines=n_engines, **kw)


def _warm_prefix(cluster, R, shared, *, rid=0, engine=0):
    rng = np.random.default_rng(99)
    req = R(rid=rid, tenant=0, max_new=2,
            prompt=np.concatenate([shared, prompt(rng, VOCAB, PTOK)]))
    cluster.submit(req, engine=engine)
    cluster.run_until_drained(max_steps=300)
    return req


def _cost_trace(package):
    """A two-engine cluster with a bounded spill tier, migration and the
    radix meter serves a mixed stream; after every router step, each
    engine's modeled dispatch cost."""
    R = request_cls(package)
    cluster = _cluster(package, 2, capacity_frames=2, spill=True,
                       migrate=True, translation="radix", max_batch=2)
    rng = np.random.default_rng(5)
    shared = prompt(rng, VOCAB, 3 * PTOK)
    reqs = [R(rid=i, tenant=i % 3, priority=int(i in (4, 5)),
              max_new=int(rng.integers(3, 9)),
              deadline_us=None if i % 2 else float(20_000 + 3_000 * i),
              prompt=(np.concatenate([shared, prompt(rng, VOCAB, 8 + i)])
                      if i % 3 == 0 else prompt(rng, VOCAB, 12 + 5 * i)))
            for i in range(8)]
    costs, tokens_costs = [], []
    for step in range(400):
        if step == 0:
            for r in reqs[:4]:
                cluster.submit(r)
        if step == 3:
            for r in reqs[4:6]:
                cluster.submit(r, engine=0)
        if step == 5:
            for r in reqs[6:]:
                cluster.submit(r)
        cluster.step()
        router = cluster.router
        costs.append([router.engine_cost_us(e) for e in cluster.engines])
        tokens_costs.append([router.engine_load(e) for e in cluster.engines])
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}, costs, tokens_costs


def test_engine_cost_us_matches_reference_at_every_step():
    runs = {pkg: _cost_trace(pkg) for pkg in PACKAGES}
    assert_same_run({pkg: v[:2] for pkg, v in runs.items()})
    assert runs["torch"][2] == runs["jax"][2]
    assert runs["torch"][3] == runs["jax"][3]
    cluster = runs["torch"][0]
    assert cluster.tier.stats["spilled_frames"] > 0
    assert any(c > 0 for step in runs["torch"][2] for c in step)
    assert sum(e.stats.translation_lookups for e in cluster.engines) > 0


def _prestage_run(package, prestage):
    """tests/test_router_cost.py's pre-stage workload: a warmed shared
    prefix, three requests reusing it and one cold one."""
    R = request_cls(package)
    rng = np.random.default_rng(13)
    shared = prompt(rng, VOCAB, 5 * PTOK)
    suffixes = [prompt(rng, VOCAB, PTOK * (1 + i % 2)) for i in range(3)]
    cold = prompt(rng, VOCAB, 24)
    cluster = _cluster(package, 1, router_prestage=prestage)
    _warm_prefix(cluster, R, shared)
    reqs = [R(rid=10 + i, tenant=0, max_new=4,
              prompt=np.concatenate([shared, suf]))
            for i, suf in enumerate(suffixes)]
    reqs.append(R(rid=20, tenant=0, prompt=cold, max_new=4))
    for r in reqs:
        cluster.submit(r)
    cluster.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}


@pytest.mark.parametrize("prestage", [False, True])
def test_prestage_matches_reference_and_keeps_tokens(prestage):
    runs = {pkg: _prestage_run(pkg, prestage) for pkg in PACKAGES}
    assert_same_run(runs)
    cluster, toks = runs["torch"]
    if prestage:
        assert cluster.router.stats.prestaged_requests >= 1
        assert cluster.engines[0].stats.prestage_hits > 0
        assert _prestage_run("torch", False)[1] == toks


def _prestage_then_steal(package):
    """A request pre-staged toward busy engine 0 and queue-stolen to idle
    engine 1 (tests/test_router_cost.py)."""
    R = request_cls(package)
    rng = np.random.default_rng(14)
    shared = prompt(rng, VOCAB, 5 * PTOK)
    heavy = [prompt(rng, VOCAB, 16) for _ in range(2)]
    r_prompt = np.concatenate([shared, prompt(rng, VOCAB, PTOK)])
    cluster = _cluster(package, 2, router_prestage=True)
    _warm_prefix(cluster, R, shared)
    hs = [R(rid=1 + i, tenant=0, prompt=p, max_new=8)
          for i, p in enumerate(heavy)]
    for h in hs:
        cluster.submit(h, engine=0)
    cluster.step()
    router = cluster.router
    r = R(rid=50, tenant=1, prompt=r_prompt.copy(), max_new=4)
    router._owner[r.rid] = 0
    cluster.engines[0].submit(r)
    router.stats.dispatched[0] = router.stats.dispatched.get(0, 0) + 1
    router._prestage_to(r, 0)
    assert cluster.engines[0]._prestage_keys
    router._steal_queued()
    assert router.stats.queued_steals == 1 and router._owner[r.rid] == 1
    assert not cluster.engines[0]._prestage_keys
    cluster.run_until_drained(max_steps=500)
    assert r.done and all(h.done for h in hs)
    cluster.check_invariants()
    return cluster, {q.rid: tuple(q.out) for q in hs + [r]}


def test_prestage_cancel_on_queued_steal_matches_reference():
    runs = {pkg: _prestage_then_steal(pkg) for pkg in PACKAGES}
    assert_same_run(runs)
    cluster = runs["torch"][0]
    assert cluster.engines[0].stats.prestage_cancelled > 0
    assert cluster.router.stats.prestage_cancels == 1


def _crash_redispatch(package):
    """A request pre-staged toward engine 0, which then crashes: it is
    re-dispatched exactly once and pre-staged afresh at the survivor."""
    R = request_cls(package)
    rng = np.random.default_rng(17)
    shared = prompt(rng, VOCAB, 5 * PTOK)
    cluster = _cluster(package, 2, router_prestage=True)
    _warm_prefix(cluster, R, shared, engine=1)
    router = cluster.router
    for i in range(2):
        cluster.submit(R(rid=1 + i, tenant=0, prompt=prompt(rng, VOCAB, 16),
                         max_new=6), engine=0)
    for i in range(2):
        cluster.submit(R(rid=3 + i, tenant=0, prompt=prompt(rng, VOCAB, 16),
                         max_new=10), engine=1)
    cluster.step()
    r = R(rid=60, tenant=1, max_new=4, deadline_us=60_000.0,
          prompt=np.concatenate([shared, prompt(rng, VOCAB, PTOK)]))
    cluster.submit(r)
    router.dispatch()
    assert router._owner[r.rid] == 0 and router._prestaged[r.rid] == 0
    before = sum(router.stats.dispatched.values())
    router._crash(0)
    assert r.rid not in router._prestaged and r.rid not in router._owner
    cluster.run_until_drained(max_steps=800)
    assert r.done
    cluster.check_invariants()
    assert sum(router.stats.dispatched.values()) == before + 3
    assert cluster.engines[1].dma.stats["refunded_us"] == 0.0
    return cluster, {q.rid: tuple(q.out) for q in [r]}


def test_crash_redispatch_of_prestaged_request_matches_reference():
    assert_same_run({pkg: _crash_redispatch(pkg) for pkg in PACKAGES})


def _queued_steal(package, pinned):
    """Hysteresis (``pinned=False``: symmetric load, nothing moves) and
    pinning (``pinned=True``: only the unpinned request moves)."""
    R = request_cls(package)
    rng = np.random.default_rng(16 if not pinned else 15)
    cluster = _cluster(package, 2)
    router = cluster.router
    if pinned:
        for i in range(2):
            cluster.submit(R(rid=1 + i, tenant=0, max_new=10,
                             prompt=prompt(rng, VOCAB, 16)), engine=0)
        cluster.step()
        cluster.submit(R(rid=40, tenant=0, max_new=4,
                         prompt=prompt(rng, VOCAB, 16)), engine=0)
        placed = [(0, 41)]
    else:
        for idx in (0, 1):
            cluster.submit(R(rid=1 + idx, tenant=0, max_new=10,
                             prompt=prompt(rng, VOCAB, 16)), engine=idx)
        cluster.step()
        placed = [(0, 40), (1, 41)]
    for idx, rid in placed:
        router._owner[rid] = idx
        cluster.engines[idx].submit(R(rid=rid, tenant=0, max_new=4,
                                      prompt=prompt(rng, VOCAB, 16)))
        router.stats.dispatched[idx] = router.stats.dispatched.get(idx, 0) + 1
    for _ in range(3):
        router._steal_queued()
    where = {r.rid: i for i, e in enumerate(cluster.engines)
             for r in e.queue}
    return router.stats.queued_steals, where, cluster_state(cluster)


@pytest.mark.parametrize("pinned", [False, True])
def test_queued_steal_hysteresis_and_pinning_match_reference(pinned):
    got, want = (_queued_steal(pkg, pinned) for pkg in ("torch", "jax"))
    assert got == want
    steals, where, _state = got
    if pinned:
        assert steals == 1 and where == {40: 0, 41: 1}
    else:
        assert steals == 0 and where == {40: 0, 41: 1}


def test_router_rejects_bad_options_and_livelock():
    from repro_torch.serving.router import RequestRouter
    with pytest.raises(AssertionError):
        _cluster("torch", 1, router_cost_model="bogus")

    class Eng:
        alive = True
        engine_id = 0
        queue: list = []
        active: list = []
        preempted: list = []

    router = RequestRouter([Eng()], tier=None, migrate=False)
    router.submit(request_cls("torch")(rid=1, tenant=0, max_new=1,
                                       prompt=np.zeros(4, np.int32)))
    with pytest.raises(RuntimeError, match="still outstanding"):
        router.run_until_drained(max_steps=0)


def _fused_drain(package):
    """A fused-mode cluster whose engine 0 preempts under a priority
    arrival; returns the tokens and, per engine after
    ``run_until_drained``, the DMA channel time still booked past its
    clock and its outbound (eviction and park) transfer and hidden µs."""
    R = request_cls(package)
    cluster = _cluster(package, 2, fault_mode="fused", decode_window_us=5.0,
                       oversubscription=3.0, max_seq=96)
    rng = np.random.default_rng(2)
    reqs = [R(rid=i, tenant=i, priority=int(i == 3), max_new=12,
              prompt=prompt(rng, VOCAB, 30 + 7 * i)) for i in range(5)]
    for r in reqs[:3]:
        cluster.submit(r, engine=0)
    for _ in range(3):
        cluster.step()
    for r in reqs[3:]:
        cluster.submit(r, engine=0)
    cluster.run_until_drained(max_steps=600)
    assert all(r.done for r in reqs)
    return ({r.rid: tuple(r.out) for r in reqs},
            [(e.dma.busy_until() - e._clock_us,
              e.dma.stats["transfer_us_out"], e.dma.stats["hidden_us_out"]
              + e.dma.stats["exposed_us_out"]) for e in cluster.engines])


def test_reference_router_leaves_fused_transfers_unsettled_and_port_not():
    """The reference's ``RequestRouter.run_until_drained`` settles only
    async engines: a fused engine ends with channel time booked past its
    clock, and its last outbound transfers are missing from its
    hidden/exposed split (which must cover every issued transfer, as
    ``ServingEngine.run_until_drained`` makes it).  The port's router
    settles fused engines too; the tokens are the same."""
    (tok_j, eng_j), (tok_t, eng_t) = (_fused_drain(p) for p in PACKAGES)
    assert tok_t == tok_j
    busy_j, out_j, split_j = eng_j[0]
    busy_t, out_t, split_t = eng_t[0]
    assert out_t == out_j > 0.0
    assert busy_j > 0.0 and split_j < out_j          # the reference
    assert busy_t <= 0.0 and split_t == out_t        # the port
    assert eng_t[1] == eng_j[1]                      # the idle engine
