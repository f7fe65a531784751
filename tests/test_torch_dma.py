"""The port's copy of ``serving/dma.py`` against the reference's.

Every check runs on both modules (``repro.serving.dma`` and
``repro_torch.serving.dma``) with the same enqueues, and the timelines and
stats dicts must be equal: the port copies the numpy DMA timeline, changing
only its import path, so both engines make the same modeled decisions.
The checks are the reference's own unit checks of the module
(tests/test_async_dma.py, tests/test_fused_decode.py).
"""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import PoolGeometry as JGeo
from repro.core.demand_paging import LinkModel as JLink
from repro.serving import dma as jdma
from repro.serving.host_tier import HostPageStore as JHost
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.core.demand_paging import LinkModel as TLink
from repro_torch.serving import dma as tdma
from repro_torch.serving.host_tier import HostPageStore as THost
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

MODULES = {"jax": (jdma, JLink), "torch": (tdma, TLink)}


def _payload():
    return (np.zeros((1, 8, 1, 4), np.float32),
            np.zeros((1, 8, 1, 4), np.float32))


def _job_view(job):
    return (job.job_id, job.keys, job.start_us, job.done_us, job.dma_count,
            job.nbytes, job.kind, job.direction, job.channel, job.settled)


def _timeline_basics(package):
    """test_async_dma.py:30 on one module; returns what it observed."""
    dma_mod, Link = MODULES[package]
    dma = dma_mod.AsyncDMAEngine(Link(setup_us=10.0, bandwidth_GBps=10.0),
                                 n_channels=1)
    job = dma.enqueue([(0, 0, 0), (0, 0, 1)], [4, 5], 1000,
                      [_payload(), _payload()], now_us=100.0)
    assert job.dma_count == 1
    assert job.start_us == 100.0
    assert job.done_us == pytest.approx(100.0 + job.transfer_us)
    job2 = dma.enqueue([(1, 0, 0)], [9], 1000, [_payload()], now_us=100.0)
    assert job2.start_us == pytest.approx(job.done_us)
    mid = job.start_us + job.transfer_us / 2
    t1 = dma.wait(job, mid)
    assert dma.stats["exposed_us"] == pytest.approx(job.transfer_us / 2)
    assert dma.stats["hidden_us"] == pytest.approx(job.transfer_us / 2)
    t2 = dma.wait(job2, mid)
    assert dma.stats["queue_us"] > 0.0
    out = dma.enqueue([(2, 0, 0)], [3], 1000, [_payload()], now_us=t2,
                      kind="evict", direction="out")
    return ([_job_view(j) for j in (job, job2, out)], t1, t2,
            dma.busy_until(), dict(dma.stats))


def _timeline_random(package):
    """test_async_dma.py:55 on one module: random enqueue/wait/drain keeps
    hidden + exposed == Σ transfer over settled jobs."""
    dma_mod, Link = MODULES[package]
    rng = np.random.default_rng(0)
    dma = dma_mod.AsyncDMAEngine(Link(setup_us=5.0, bandwidth_GBps=8.0),
                                 n_channels=2)
    now, settled, jobs, trace = 0.0, 0.0, [], []
    for i in range(60):
        now += float(rng.uniform(0, 30))
        n = int(rng.integers(1, 6))
        ppns = sorted(rng.choice(100, size=n, replace=False).tolist())
        direction = "out" if rng.random() < 0.2 else "in"
        job = dma.enqueue([(i, 0, v) for v in range(n)], ppns, 2048,
                          [_payload()] * n, now, direction=direction)
        assert job.start_us >= now
        assert job.done_us == pytest.approx(job.start_us + job.transfer_us)
        jobs.append(job)
        trace.append(_job_view(job))
        act = rng.random()
        if act < 0.4 and jobs:
            j = jobs.pop(int(rng.integers(len(jobs))))
            if not j.settled and j.direction == "in":
                settled += j.transfer_us
            now = dma.wait(j, now)
            assert now >= j.done_us - 1e-9
        elif act < 0.7:
            for j in dma.drain(now):
                jobs.remove(j)
                if j.direction == "in":
                    settled += j.transfer_us
                trace.append(("drained", j.job_id))
    for j in dma.drain(float("inf")):
        if j.direction == "in":
            settled += j.transfer_us
    assert dma.stats["hidden_us"] + dma.stats["exposed_us"] == \
        pytest.approx(settled)
    assert not dma.in_flight
    return trace, now, dict(dma.stats)


def _page_done(package):
    """test_fused_decode.py:171: per-page arrival times are monotone and
    end at the job's completion."""
    dma_mod, Link = MODULES[package]
    dma = dma_mod.AsyncDMAEngine(Link(setup_us=10.0, bandwidth_GBps=10.0),
                                 n_channels=1)
    job = dma.enqueue([(0, 0, i) for i in range(4)], list(range(4)), 1000,
                      [_payload()] * 4, now_us=50.0)
    times = [job.page_done_us(i) for i in range(4)]
    assert all(b > a for a, b in zip(times, times[1:]))
    assert times[0] > job.start_us
    assert times[-1] == pytest.approx(job.done_us)
    return times


def _staging(package):
    """test_async_dma.py:97 and test_fused_decode.py:183: double-buffer
    ownership and slot addressing."""
    st = MODULES[package][0].StagingBuffer()
    p = _payload()
    st.stage((0, 0, 0), p)
    assert not st.has((0, 0, 0)) and st.contains((0, 0, 0))
    assert st.consume((0, 0, 0)) is None
    st.swap()
    assert st.has((0, 0, 0))
    assert st.consume((0, 0, 0)) is p
    assert st.consume((0, 0, 0)) is None
    st.stage((1, 0, 0), p)
    st.stage((1, 0, 1), p)
    s0, s1 = st.slot_of((1, 0, 0)), st.slot_of((1, 0, 1))
    assert s0 is not None and s1 is not None and s0 != s1
    assert st.slot_of((9, 9, 9)) is None
    st.swap()
    st.swap()
    assert st.has((1, 0, 0)) and st.slot_of((1, 0, 0)) == s0
    st.consume((1, 0, 0))
    assert st.slot_of((1, 0, 0)) is None
    st.stage((2, 0, 0), p)
    assert st.invalidate_seq(2) == 1
    assert st.invalidate_seq(1) == 1
    assert len(st) == 0
    return (s0, s1), dict(st.stats)


@pytest.mark.parametrize("check", [_timeline_basics, _timeline_random,
                                   _page_done, _staging],
                         ids=["timeline", "random", "page_done", "staging"])
def test_dma_module_matches_reference(check):
    assert check("torch") == check("jax")


@pytest.mark.parametrize("duplex", [True, False])
def test_half_duplex_shares_one_timeline(duplex):
    """Outbound jobs queue behind inbound ones only on a half-duplex link,
    in both modules alike."""
    seen = {}
    for package, (dma_mod, Link) in MODULES.items():
        dma = dma_mod.AsyncDMAEngine(Link(), n_channels=1, duplex=duplex)
        a = dma.enqueue([(0, 0, 0)], [0], 4096, [_payload()], 0.0)
        b = dma.enqueue([(1, 0, 0)], [7], 4096, [_payload()], 0.0,
                        kind="evict", direction="out")
        assert (b.start_us == a.done_us) == (not duplex)
        seen[package] = (_job_view(a), _job_view(b), dict(dma.stats))
    assert seen["torch"] == seen["jax"]


def _cache_state(package):
    """A 2-shard cache with three sequences, some pages demoted to the
    host store: what Prefetcher.predict sees in an engine step."""
    geo_kw = dict(page_tokens=8, frame_pages=4, compact_threshold=0.4)
    if package == "jax":
        cache = JCache(JGeo(**geo_kw), 32, 2, "mosaic", link=JLink(),
                       page_bytes=4096)
        host = JHost()
    else:
        cache = TCache(TGeo(**geo_kw), 32, 2, "mosaic", link=TLink(),
                       page_bytes=4096)
        host = THost()
    for seq, n in ((0, 40), (1, 20), (2, 70)):
        cache.allocate(seq, n)
    for seq in (0, 2):
        for s, vpn, _ppn in cache.mapped_pages(seq)[::3]:
            host.put(seq, s, vpn, *_payload())
        cache.demote_host_backed(seq, host)
    for vpn in range(3):
        host.put(5, 0, vpn, *_payload())     # a preempted request
    return cache, host


@pytest.mark.parametrize("slacks", [[None, None], [50.0, None, 2000.0],
                                    [10.0, 20.0, 30.0, None]])
def test_prefetcher_plan_and_predict_match_reference(slacks):
    out = {}
    for package, (dma_mod, _Link) in MODULES.items():
        cache, host = _cache_state(package)
        pf = dma_mod.Prefetcher(depth=2)
        depth = pf.plan_depth(slacks, 1000.0)
        preds = pf.predict(cache, host, [0, 1, 2], [5, 9], depth=depth)
        assert preds, "nothing to prefetch: the check is vacuous"
        out[package] = (depth, preds, dict(pf.stats),
                        cache.host_backed_pages([0, 1, 2], host))
    assert out["torch"] == out["jax"]


def test_engine_stats_fields_cover_the_reference_async_fields():
    """The port's EngineStats carries every async/fused field the reference
    reports, under the same names."""
    from repro.serving.engine import EngineStats as JStats
    from repro_torch.serving.engine import EngineStats as TStats
    wanted = {"fault_exposed_us", "fault_hidden_us", "prefetch_hits",
              "prefetch_misses", "prefetch_wasted", "evict_pages",
              "evict_dmas", "bytes_out", "evict_us", "fused_ready_pages",
              "fused_drained_pages", "fused_tail_us"}
    j = {f.name for f in dataclasses.fields(JStats)}
    t = {f.name for f in dataclasses.fields(TStats)}
    assert wanted <= j and wanted <= t
    s = TStats(fault_exposed_us=12.5, fault_hidden_us=37.5,
               fused_ready_pages=2, fused_drained_pages=1)
    line = s.summary()
    assert "38us hidden / 12us exposed, modeled" in line
    assert "fused 2 ready + 1 drained" in line
