"""The port's failure model (``serving/faults.py``, ``SpillStore``, the
tier's retry / quarantine / degrade paths, crash recovery) against the
reference's.

* ``SpillStore``: a frame of bfloat16 (and float32) torch pages comes back
  with the same dtype, shape and bits; its digest equals the reference's
  for the same bytes (numpy's bfloat16 there), so an injected bit flip
  lands on the same byte and the checksum catches it in both.
* The tier's failure paths of tests/test_faults.py (transient-read retry
  with backoff, quarantine of an unreadable or corrupted frame, degrade to
  the hard cap, un-degrade after clean probes, domain reclaim) driven
  through both packages: the tier, spill-store and injector counters, the
  injector's log, the lost sequences and the surviving payload bytes
  equal the reference's.
* Clusters on the f32 smoke config with bridged weights: an engine crash
  (tests/test_faults.py) and a bounded spill tier with and without disk
  (tests/test_spill.py) give the reference's tokens and counters, and the
  tokens of an unfaulted, unbounded run.
* ``chip_smoke.py``'s phase 8b rehearsed at smoke width on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PoolGeometry as JGeo
from repro.serving.cluster import PREFIX_DOMAIN
from repro.serving.cluster import SharedHostTier as JTier
from repro.serving.host_tier import SpillStore as JSpill
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.serving.cluster import SharedHostTier as TTier
from repro_torch.serving.faults import SpillCorruptionError
from repro_torch.serving.host_tier import SpillStore as TSpill
from test_torch_cluster_helpers import (PACKAGES, assert_same_run,
                                        chip_smoke, fault_injector,
                                        make_cluster, prompt, request_cls)
from test_torch_parity_helpers import bridged

pytestmark = pytest.mark.faults

GEO = dict(page_tokens=8, frame_pages=2, compact_threshold=0.4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pages(seed, n=3, shape=(4, 8, 2, 16)):
    """``n`` (k, v) pages of random bfloat16 bits as torch tensors, and
    the same bits as numpy bfloat16 arrays (the reference's payloads)."""
    gen = torch.Generator().manual_seed(seed)
    pages_t, pages_n = [], []
    for _ in range(n):
        kv = [torch.randn(shape, generator=gen).to(torch.bfloat16)
              for _ in range(2)]
        pages_t.append(tuple(kv))
        pages_n.append(tuple(t.view(torch.int16).numpy().view(jnp.bfloat16)
                             for t in kv))
    return pages_t, pages_n


def test_spillstore_bf16_round_trip_is_byte_exact(tmp_path):
    pages, _ = _bf16_pages(0)
    f32 = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),) * 2
    keys = [(5, 0, i) for i in range(len(pages) + 1)]
    with TSpill(str(tmp_path)) as store:
        nbytes = store.write_frame(3, 1, list(zip(keys, pages + [f32])))
        assert nbytes == sum(k.nbytes + v.nbytes for k, v in pages + [f32])
        back = store.read_frame(3, expect_domain=1)
    assert [k for k, _ in back] == keys
    for (_, (k, v)), (k0, v0) in zip(back, pages + [f32]):
        for got, want in ((k, k0), (v, v0)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8).reshape(-1),
                               want.contiguous().view(torch.uint8)
                               .reshape(-1))


def test_spillstore_digest_and_bit_flip_match_reference(tmp_path):
    """Same bf16 bytes, same seeded corruption plan: the two stores record
    the same digest, flip the same byte, and both refuse the frame."""
    pages_t, pages_n = _bf16_pages(1)
    keys = [(7, 0, i) for i in range(len(pages_t))]
    stores = {
        "jax": JSpill(str(tmp_path / "j"),
                      injector=fault_injector("jax", corrupt_frames=(7,))),
        "torch": TSpill(str(tmp_path / "t"),
                        injector=fault_injector("torch",
                                                corrupt_frames=(7,)))}
    for pkg, pages in (("jax", pages_n), ("torch", pages_t)):
        stores[pkg].write_frame(7, "dom", list(zip(keys, pages)))
        stores[pkg].write_frame(8, "dom", list(zip(keys, pages)))
    assert stores["torch"]._frames[7][4] == stores["jax"]._frames[7][4]
    assert stores["torch"].injector.log == stores["jax"].injector.log
    with pytest.raises(SpillCorruptionError):
        stores["torch"].read_frame(7)
    from repro.serving.faults import SpillCorruptionError as JCorrupt
    with pytest.raises(JCorrupt):
        stores["jax"].read_frame(7)
    back = stores["torch"].read_frame(8)
    assert all(torch.equal(b[1][0], p[0]) for b, p in zip(back, pages_t))
    for store in stores.values():
        assert store.stats["checksum_failures"] == 1
        store.close()


# ------------------------------------------------------- tier failure paths


def _tier(package, tmp_path, **kw):
    kw.setdefault("capacity_frames", 2)
    cls, geo = (JTier, JGeo) if package == "jax" else (TTier, TGeo)
    return cls(geo(**GEO), n_engines=1, spill_dir=str(tmp_path / package),
               **kw)


def _payload(package, tag):
    k = np.full((2, 3), tag, np.float32)
    return (k, -k) if package == "jax" else (torch.from_numpy(k),
                                             torch.from_numpy(-k))


def _bytes(x):
    return (x.numpy() if isinstance(x, torch.Tensor) else x).tobytes()


def _scenario(package, tmp_path, name):
    """One failure path of tests/test_faults.py; returns what both
    packages must agree on."""
    plans = {
        "retry": dict(disk_read_error_rate=1.0, max_transient_failures=2),
        "permanent": dict(permanent_read_frames=(0, 1, 2, 3)),
        "corrupt": dict(corrupt_write_rate=1.0),
        "degrade": dict(disk_write_error_rate=1.0,
                        max_transient_failures=10 ** 6),
        "undegrade": dict(seed=1, disk_write_error_rate=1.0,
                          max_transient_failures=2),
        "reclaim": None,
    }
    tier_kw = {
        "retry": dict(disk_retries=3, retry_backoff_us=50.0,
                      disk_error_rate_threshold=2.0),
        "permanent": dict(disk_error_rate_threshold=2.0),
        "corrupt": dict(disk_error_rate_threshold=2.0),
        "degrade": dict(disk_retries=3),
        "undegrade": dict(undegrade_probe_interval_us=100.0,
                          undegrade_probe_successes=3),
        "reclaim": {},
    }[name]
    inj = None if plans[name] is None else fault_injector(package,
                                                          **plans[name])
    tier = _tier(package, tmp_path, injector=inj, **tier_kw)
    v = tier.view(0)
    n = 12 if name == "undegrade" else 8
    if name == "reclaim":
        tier.view(PREFIX_DOMAIN).put(-1, 0, 0, *_payload(package, 50.0))
    for i in range(n):
        v.put(9, 0, i, *_payload(package, float(i)))
    extra = None
    if name == "undegrade":
        t = 0.0
        for _ in range(20):
            t += 1000.0
            tier.pump(t)
    else:
        tier.flush()
    if name == "retry":
        extra = _bytes(v.peek(*sorted(tier._spilled)[0])[0])
    elif name == "permanent":
        extra = (tier.ensure_resident([sorted(tier._spilled)[0]]),
                 tier.take_lost(9), tier.take_lost(9))
    elif name == "corrupt":
        extra = tier.ensure_resident(sorted(tier._spilled))
    elif name == "reclaim":
        extra = (tier.reclaim_domain(0), tier.seq_pages(9),
                 tier.seq_pages(-1))
    tier.check_invariants()
    state = (dict(tier.stats), dict(tier.frames.stats),
             dict(tier.spill_store.stats), sorted(tier.lost_seqs),
             tier.degraded, tier.spill_enabled, sorted(tier._spilled),
             {k: (_bytes(kv[0]), _bytes(kv[1]))
              for k, kv in tier.store._pages.items()},
             None if inj is None else (dict(inj.stats), list(inj.log)),
             extra)
    tier.spill_store.close()
    return state


@pytest.mark.parametrize("name", ["retry", "permanent", "corrupt", "degrade",
                                  "undegrade", "reclaim"])
def test_tier_failure_paths_match_reference(tmp_path, name):
    got, want = (_scenario(pkg, tmp_path, name) for pkg in ("torch", "jax"))
    assert got == want
    stats, lost, degraded, extra = got[0], got[3], got[4], got[9]
    expect = {
        "retry": lambda: stats["disk_retries"] == 2
        and stats["retry_backoff_us"] == 150.0,
        "permanent": lambda: stats["frames_quarantined"] == 1
        and lost == [] and extra[1] and not extra[2],
        "corrupt": lambda: stats["frames_quarantined"] >= 1 and lost == [9],
        "degrade": lambda: degraded and stats["degrades"] == 1,
        "undegrade": lambda: not degraded and stats["undegrades"] >= 1,
        "reclaim": lambda: extra[0] >= 1 and extra[1] == []}
    assert expect[name]()


# ------------------------------------------------------------ clusters


def _crash_run(package, plan):
    """tests/test_faults.py's crash recovery: three requests overload
    engine 0, one on engine 1; ``plan`` may crash engine 0 at step 2."""
    vocab = bridged("qwen2.5-3b")[0].vocab_size
    R = request_cls(package)
    inj = None if plan is None else fault_injector(package, **plan)
    cluster = make_cluster(package, n_engines=2, max_batch=2, max_seq=64,
                           seed=0, prefix_cache=False, migrate=False,
                           decode_window_us=1000.0, fault_injector=inj)
    rng = np.random.default_rng(3)
    reqs = [R(rid=i, tenant=0, priority=2 if i == 2 else 0, max_new=6,
              prompt=prompt(rng, vocab, 16)) for i in range(4)]
    for r in reqs[:3]:
        cluster.submit(r, engine=0)
    cluster.submit(reqs[3], engine=1)
    cluster.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}


def test_crash_recovery_matches_reference_and_the_unfaulted_run():
    plan = dict(engine_crashes=((2, 0),))
    runs = {pkg: _crash_run(pkg, plan) for pkg in PACKAGES}
    assert_same_run(runs)
    cluster, toks = runs["torch"]
    assert toks == _crash_run("torch", None)[1]
    rs = cluster.router.stats
    assert rs.crashes == 1 and rs.recovered_requeued >= 1
    assert not cluster.engines[0].alive and cluster.engines[1].alive


def _capped_run(package, capacity_frames, spill, plan=None):
    """tests/test_spill.py's capped cluster: six requests over three
    shared 40-token prefixes, two waves, the host tier bounded at
    ``capacity_frames`` (None: unbounded)."""
    vocab = bridged("qwen2.5-3b")[0].vocab_size
    R = request_cls(package)
    inj = None if plan is None else fault_injector(package, **plan)
    cluster = make_cluster(package, n_engines=2, max_batch=4, max_seq=128,
                           seed=0, decode_window_us=1000.0,
                           capacity_frames=capacity_frames, spill=spill,
                           fault_injector=inj)
    rng = np.random.default_rng(1)
    shared = [prompt(rng, vocab, 40) for _ in range(3)]
    reqs = [R(rid=i, tenant=i % 3, max_new=4, prompt=np.concatenate(
        [shared[i % 3], prompt(rng, vocab, 8)])) for i in range(6)]
    for r in reqs[:3]:
        cluster.submit(r)
    cluster.run_until_drained(max_steps=1000)
    for r in reqs[3:]:
        cluster.submit(r)
    cluster.run_until_drained(max_steps=2000)
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}


@pytest.mark.parametrize("capacity,spill,plan", [
    (3, True, None),
    (3, False, None),
    (3, True, dict(seed=2, disk_read_error_rate=0.5, corrupt_frames=(1,))),
])
def test_capped_cluster_matches_reference(capacity, spill, plan):
    runs = {pkg: _capped_run(pkg, capacity, spill, plan) for pkg in PACKAGES}
    assert_same_run(runs)
    cluster, toks = runs["torch"]
    ts = cluster.tier.stats
    if spill:
        assert ts["spilled_frames"] > 0
    if plan is None:
        assert toks == _capped_run("torch", None, True)[1]
        if spill:
            assert ts["promoted_frames"] > 0
            assert cluster.stats().totals.promote_stall_us > 0.0
    else:
        assert ts["frames_quarantined"] >= 1 or ts["disk_retries"] >= 1


def test_chip_smoke_phase_8b_on_cpu():
    """chip_smoke.py's phase 8b rehearsed at smoke width on the CPU:
    engine 1 crashes mid-stream, transient read errors are retried and
    the corrupted request frame is quarantined; every request completes
    its tokens, the dead engine holds no host frame after the crash while
    the prefix frames survive, and a lost-payload restart is counted."""
    cs = chip_smoke()
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
    run, _reqs, _counts, _wall = cs.serve_cluster(cfg, device="cpu")
    plan = cs.crash_plan(run.stream_start)
    run, reqs, counts, _wall = cs.serve_cluster(cfg, device="cpu", plan=plan)
    cs.check_cluster_run(cfg, "cluster:b", run, reqs, counts, faulted=True)
    inj = run.cluster.fault_injector
    assert inj.plan.corrupt_frames and inj.stats["corrupted_frames"] >= 1
    assert run.after_crash["recovered_bundles"] >= 1
