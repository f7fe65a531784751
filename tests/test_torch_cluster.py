"""The port's cluster tier (``serving/cluster.py``, ``serving/router.py``,
the engine's cluster hooks) against the reference's.

* Frame table, store views and tier: the same seeded sequence of puts,
  pumps, flushes, promotes, migrations, drops and domain reclaims drives
  both packages' ``SharedHostTier`` (a capacity bound and a disk spill
  directory underneath); after every operation the invariants hold and
  the frame-table, tier, store and spill-store counters, the resident and
  spilled keys and the payload bytes equal the reference's.
* ``ServingCluster`` on the f32 smoke config with bridged weights: the
  shared-prefix workload of tests/test_cluster.py on one and two engines
  (cross-engine prefix hits) and its work-stealing workload with and
  without migration give the reference's tokens per request,
  ``RouterStats``, frame-table and tier counters and every engine's
  modeled counters; tokens are identical across engine counts and with
  migration on or off, and the thief re-prefills nothing.
* A non-dense replica on a shared index skips its parks, as the
  reference's.
* ``chip_smoke.py``'s phase 8a rehearsed at smoke width on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import PoolGeometry as JGeo
from repro.serving.cluster import SharedHostTier as JTier
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.serving.cluster import HostFrameTable as TFrames
from repro_torch.serving.cluster import SharedHostTier as TTier
from test_torch_cluster_helpers import (GEO_KW, PACKAGES, assert_same_run,
                                        chip_smoke, make_cluster, payload,
                                        prompt, request_cls)
from test_torch_parity_helpers import bridged

ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ host tier


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tier_state(tier):
    return (dict(tier.frames.stats), dict(tier.stats),
            dict(tier.store.stats), dict(tier.spill_store.stats),
            sorted(tier.store._pages), sorted(tier._spilled),
            {k: tier.frames.owner_of(k) for k in tier.frames._key_frame},
            {k: (_as_np(kv[0]).tobytes(), _as_np(kv[1]).tobytes())
             for k, kv in tier.store._pages.items()})


def test_tier_matches_reference_under_random_failure_sequences(tmp_path):
    """tests/test_cluster.py's randomized failure sequence (placement,
    write-back pumping, spill and promote, migration, drops and domain
    reclaims), driven op for op through both packages' tiers."""
    geo = dict(page_tokens=8, frame_pages=2, compact_threshold=0.4)
    tiers = {
        "jax": JTier(JGeo(**geo), n_engines=3, capacity_frames=4,
                     spill=True, spill_dir=str(tmp_path / "jax")),
        "torch": TTier(TGeo(**geo), n_engines=3, capacity_frames=4,
                       spill=True, spill_dir=str(tmp_path / "torch"))}
    rng = np.random.default_rng(11)
    home, next_vpn = {}, {}
    for _ in range(250):
        op = int(rng.integers(0, 7))
        if op <= 1 or not home:
            seq = int(rng.integers(0, 12))
            d = home.setdefault(seq, int(rng.integers(0, 3)))
            vpn = next_vpn.get(seq, 0)
            for pkg, tier in tiers.items():
                tier.view(d).put(seq, 0, vpn, *payload(pkg, float(seq + vpn)))
            next_vpn[seq] = vpn + 1
        elif op == 2:
            dt = float(rng.integers(1, 5000))
            for tier in tiers.values():
                tier.pump(tier._now_us + dt)
        elif op == 3:
            for tier in tiers.values():
                tier.flush()
        elif op == 4 and tiers["jax"]._spilled:
            keys = sorted(tiers["jax"]._spilled)
            key = keys[int(rng.integers(0, len(keys)))]
            for tier in tiers.values():
                tier.ensure_resident([key])
        elif op == 5:
            seq = sorted(home)[int(rng.integers(0, len(home)))]
            dst = int(rng.integers(0, 3))
            if dst != home[seq]:
                for tier in tiers.values():
                    tier.migrate_seq(seq, dst)
                home[seq] = dst
        else:
            d = int(rng.integers(0, 3))
            if rng.random() < 0.5:
                for tier in tiers.values():
                    tier.reclaim_domain(d)
                for seq in [s for s, dd in home.items() if dd == d]:
                    home.pop(seq)
                    next_vpn.pop(seq, None)
            elif home:
                seq = sorted(home)[int(rng.integers(0, len(home)))]
                d = home.pop(seq)
                for tier in tiers.values():
                    tier.view(d).drop_seq(seq)
                next_vpn.pop(seq, None)
        for tier in tiers.values():
            tier.check_invariants()
        assert _tier_state(tiers["torch"]) == _tier_state(tiers["jax"])
    t = tiers["torch"]
    assert t.stats["spilled_frames"] > 0 and t.stats["promoted_frames"] > 0
    assert t.stats["reclaimed_frames"] > 0
    for tier in tiers.values():
        tier.spill_store.close()


def test_frame_table_migrate_shapes_match_reference():
    """Whole-frame owner flip, re-placement out of a shared frame, stale
    keys and a same-owner no-op (tests/test_cluster.py), both packages."""
    from repro.serving.cluster import HostFrameTable as JFrames
    out = []
    for cls in (JFrames, TFrames):
        ft = cls(frame_pages=2)
        whole, mig, stay = [(1, 0, 0), (1, 0, 1)], [(2, 0, 0)], [(3, 0, 0)]
        for k in whole + mig + stay:
            ft.place(0, k)
        ft.place(1, (4, 0, 0))
        moved = ft.migrate(whole + mig + [(4, 0, 0), (9, 9, 9)], dst=1)
        ft.release((1, 0, 1))
        moved2 = ft.migrate(whole, dst=2)
        ft.check_invariants()
        out.append((moved, moved2, dict(ft.stats),
                    {k: ft.owner_of(k) for k in ft._key_frame}))
    assert out[1] == out[0]
    assert out[1][2]["whole_frame_moves"] >= 1


# -------------------------------------------------------------- cluster


def _shared_prefix_run(package, n_engines):
    """tests/test_cluster.py's ``_run_cluster``: one request pinned to
    engine 0, then four more sharing its 24-token prefix, routed."""
    vocab = bridged(ARCH)[0].vocab_size
    R = request_cls(package)
    cluster = make_cluster(package, n_engines=n_engines, max_batch=4,
                           max_seq=96, seed=0, decode_window_us=1000.0)
    rng = np.random.default_rng(0)
    shared = prompt(rng, vocab, 24)
    reqs = [R(rid=i, tenant=i % 2, max_new=3,
              prompt=np.concatenate([shared, prompt(rng, vocab, 8)]))
            for i in range(5)]
    cluster.submit(reqs[0], engine=0)
    cluster.run_until_drained(max_steps=300)
    for r in reqs[1:]:
        cluster.submit(r)
    cluster.run_until_drained(max_steps=600)
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}


@pytest.fixture(scope="module")
def shared_prefix_runs():
    return {n: {pkg: _shared_prefix_run(pkg, n) for pkg in PACKAGES}
            for n in (1, 2)}


@pytest.mark.parametrize("n_engines", [1, 2])
def test_cluster_shared_prefix_matches_reference(shared_prefix_runs,
                                                 n_engines):
    assert_same_run(shared_prefix_runs[n_engines])


def test_cluster_tokens_identical_across_engine_counts(shared_prefix_runs):
    one, two = (shared_prefix_runs[n]["torch"] for n in (1, 2))
    assert one[1] == two[1]
    cluster = two[0]
    e0, e1 = (e.stats for e in cluster.engines)
    assert e0.prefix_parked_pages > 0 and e1.prefix_hits > 0
    assert cluster.tier.store.request_pages() == 0
    assert all(e.lm is cluster.engines[0].lm for e in cluster.engines)


def _steal_run(package, migrate):
    """tests/test_cluster.py's ``_run_steal``: a long request on engine 0,
    then two premium ones pinned there too; engine 1 steals."""
    vocab = bridged(ARCH)[0].vocab_size
    R = request_cls(package)
    cluster = make_cluster(package, n_engines=2, max_batch=2, max_seq=96,
                           seed=0, migrate=migrate, prefix_cache=False,
                           decode_window_us=1000.0)
    rng = np.random.default_rng(2)
    victim = R(rid=0, tenant=0, priority=0, prompt=prompt(rng, vocab, 40),
               max_new=16)
    premium = [R(rid=i, tenant=1, priority=2, prompt=prompt(rng, vocab, 48),
                 max_new=10) for i in range(1, 3)]
    cluster.submit(victim, engine=0)
    for _ in range(2):
        cluster.step()
    for r in premium:
        cluster.submit(r, engine=0)
    cluster.run_until_drained(max_steps=600)
    reqs = [victim] + premium
    assert all(r.done for r in reqs)
    cluster.check_invariants()
    return cluster, {r.rid: tuple(r.out) for r in reqs}


@pytest.mark.parametrize("migrate", [True, False])
def test_cluster_work_stealing_matches_reference(migrate):
    runs = {pkg: _steal_run(pkg, migrate) for pkg in PACKAGES}
    assert_same_run(runs)
    cluster, toks = runs["torch"]
    r = cluster.router.stats
    if migrate:
        assert r.migrations >= 1 and r.migrated_pages > 0
        dst = cluster.engines[1].stats
        assert dst.prefill_tokens == 0 and dst.decode_tokens > 0
        assert dst.faults >= r.migrated_pages and dst.landings >= 1
        assert _steal_run("torch", False)[1] == toks
    else:
        assert r.migrations == 0
        assert cluster.engines[1].stats.decode_tokens == 0


def test_moe_replica_skips_parks_into_a_shared_index_as_reference():
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.host_tier import HostPageStore as JStore
    from repro.serving.host_tier import PrefixIndex as JIndex
    from repro_torch.serving.engine import ServingEngine as TEngine
    from repro_torch.serving.host_tier import HostPageStore as TStore
    from repro_torch.serving.host_tier import PrefixIndex as TIndex
    jcfg, _jlm, jparams, tlm = bridged("dbrx-132b")
    out = {}
    for pkg in PACKAGES:
        store = JStore() if pkg == "jax" else TStore()
        idx = (JIndex if pkg == "jax" else TIndex)(store,
                                                   GEO_KW["page_tokens"])
        kw = dict(max_batch=2, max_seq=64, seed=0, prefix_index=idx)
        eng = (JEngine(jcfg, geometry=JGeo(**GEO_KW), params=jparams, **kw)
               if pkg == "jax" else
               TEngine(tlm.cfg, geometry=TGeo(**GEO_KW), params=tlm,
                       device="cpu", **kw))
        assert not eng.prefix_supported and eng.prefix is idx
        R = request_cls(pkg)
        rng = np.random.default_rng(0)
        shared = prompt(rng, jcfg.vocab_size, 24)
        reqs = [R(rid=i, tenant=0, max_new=2, prompt=np.concatenate(
            [shared, prompt(rng, jcfg.vocab_size, 6)])) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_steps=200)
        assert all(r.done for r in reqs)
        out[pkg] = ({r.rid: tuple(r.out) for r in reqs},
                    eng.stats.prefix_park_skipped, eng.stats.prefix_hits,
                    len(idx), len(store))
    assert out["torch"] == out["jax"] == (out["jax"][0], 3, 0, 0, 0)


# ----------------------------------------------------------- chip smoke


def test_chip_smoke_phase_8a_on_cpu():
    """chip_smoke.py's phase 8a rehearsed at smoke width on the CPU: two
    runs pass its gates (migration with a whole-frame flip and the landed
    pages checked bit for bit, no re-prefill, cross-engine prefix hits,
    spill and promote, invariants after every router step, lookups on both
    engines) and reproduce each other exactly."""
    cs = chip_smoke()
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="float32")
    sigs = []
    for _ in range(2):
        run, reqs, counts, _wall = cs.serve_cluster(cfg, device="cpu")
        cs.check_cluster_run(cfg, "cluster:a", run, reqs, counts)
        assert run.cluster.router.stats.migrations >= 1 and run.landed
        sigs.append(cs.cluster_signature(run, reqs))
    assert sigs[1] == sigs[0]
