"""The port's prefix cache and suffix prefill vs the reference's.

* ``PrefixIndex``: one seeded sequence of park / match / peek / evict
  operations on both packages' indexes gives the same chain hashes byte
  for byte, the same matches and the same evictions.
* ``LM.prefill`` with ``prefix_kv``: the port against the reference at
  1e-4 on the f32 smoke config (same weights, same cached prefix K/V; the
  same math in another framework sums in another order).
* Suffix prefill reproduces full prefill bitwise inside the port (the
  counterpart of tests/test_prefix_cache.py:156) on the bf16 smoke config,
  whose K/V pools hold exactly what its projections produce.
* Engine: the two-wave shared-prefix workload of test_prefix_cache.py:227
  with its geometry.  On the f32 smoke config with bridged weights the
  port emits the reference's greedy tokens and equal modeled prefix,
  fault and DMA counters in sync, async and fused; on the bf16 smoke config
  the cache on and off give identical tokens inside the port, and
  chip_smoke.py's phase 4b passes its checks at smoke width.

The port runs its kernels' plain versions here (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models.lm import LM as JLM
from repro.models.transformer import PageCtx as JCtx
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.host_tier import HostPageStore as JStore
from repro.serving.host_tier import PrefixIndex as JIndex
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models.lm import LM as TLM
from repro_torch.models.transformer import PREFILL_ROWS
from repro_torch.models.page_ops import PageCtx as TCtx
from repro_torch.serving.engine import EngineStats
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.host_tier import HostPageStore as TStore
from repro_torch.serving.host_tier import PrefixIndex as TIndex

GEO_KW = dict(page_tokens=8, frame_pages=4, compact_threshold=0.4)
PTOK = GEO_KW["page_tokens"]
F32 = dict(rtol=1e-4, atol=1e-4)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_reused_tokens",
            "prefix_parked_pages", "prefix_fault_us", "admit_hits",
            "admit_colds", "prefill_tokens", "faults", "fault_dmas",
            "bytes_in", "transfer_us", "fault_exposed_us", "fault_hidden_us",
            "prefetch_hits", "prefetch_misses", "prefetch_wasted",
            "evict_pages", "evict_dmas", "bytes_out", "evict_us",
            "fused_ready_pages", "fused_drained_pages", "fused_tail_us",
            "swaps_out", "compaction_copies")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain versions run on tiny tensors here: one intra-op
    thread keeps them from spinning against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ PrefixIndex


def test_prefix_index_matches_reference_op_for_op():
    """Chained hashes, matches, LRU evictions (prefix-closed) and store
    contents agree after every operation of a seeded sequence over prompts
    that share and diverge at page boundaries, at a capacity that forces
    evictions."""
    rng = np.random.default_rng(0)
    stores = JStore(), TStore()
    idx = (JIndex(stores[0], PTOK, capacity_pages=7),
           TIndex(stores[1], PTOK, capacity_pages=7))
    roots = [rng.integers(0, 50, 3 * PTOK) for _ in range(3)]
    prompts = []
    for _ in range(12):
        base = roots[int(rng.integers(0, 3))]
        tail = rng.integers(0, 50, int(rng.integers(0, 3 * PTOK)))
        prompts.append(np.concatenate(
            [base[:PTOK * int(rng.integers(0, 4))], tail]).astype(np.int32))
    for step in range(40):
        toks = prompts[int(rng.integers(0, len(prompts)))]
        hj, ht = (i.chain_hashes(toks) for i in idx)
        assert hj == ht and all(isinstance(h, bytes) for h in ht)
        op = rng.integers(0, 4)
        if op == 0:                       # park the missing chain suffix
            start = idx[1].missing_from(ht)
            assert start == idx[0].missing_from(hj)
            parent = ht[start - 1] if start else None
            for gp in range(start, len(ht)):
                tag = float(step * 100 + gp)
                kj = np.full((1, PTOK, 1, 4), tag, np.float32)
                pages = [i.park(ht[gp], parent, gp, 0, gp, *kv) for i, kv in
                         zip(idx, ((kj, -kj), (torch.from_numpy(kj),
                                               torch.from_numpy(-kj))))]
                assert pages[0].owner == pages[1].owner
                parent = ht[gp]
        elif op == 1:
            (nj, pj), (nt, pt) = (i.match(toks) for i in idx)
            assert nj == nt
            assert [(p.page_index, p.owner, p.tick, p.hits) for p in pj] \
                == [(p.page_index, p.owner, p.tick, p.hits) for p in pt]
            for a, b in zip(pj, pt):
                np.testing.assert_array_equal(
                    idx[0].payload(a)[0], idx[1].payload(b)[0].numpy())
        elif op == 2:
            (nj, pj), (nt, pt) = (i.peek_match(toks) for i in idx)
            assert nj == nt and [p.owner for p in pj] == [p.owner for p in pt]
        elif step % 3 == 0:
            owners = sorted({p.owner for p in idx[1]._pages.values()})[:2]
            assert idx[0].evict_owner_pages(owners) \
                == idx[1].evict_owner_pages(owners)
        assert idx[0].stats == idx[1].stats
        assert sorted(stores[0]._pages) == sorted(stores[1]._pages)
        assert stores[0].stats == stores[1].stats
    assert idx[1].stats["evicted_pages"] > 0 and len(idx[1]) <= 7
    for page in idx[1]._pages.values():
        assert page.parent is None or page.parent in idx[1]._pages
    assert idx[0].drop_all() == idx[1].drop_all()
    assert len(stores[1]) == 0


def test_host_store_kinds_and_discard_match_reference():
    stores = JStore(), TStore()
    kv = np.zeros((1, PTOK, 1, 4), np.float32)
    for i, kind in enumerate(("swap", "prefix", "reuse", "promote", "swap")):
        stores[0].put(i, 0, i, kv, kv, kind=kind)
        stores[1].put(i, 0, i, torch.from_numpy(kv), torch.from_numpy(kv),
                      kind=kind)
    assert [s.discard(1, 0, 1) for s in stores] == [True, True]
    assert [s.discard(1, 0, 1) for s in stores] == [False, False]
    assert stores[0].stats == stores[1].stats
    assert sorted(stores[0]._pages) == sorted(stores[1]._pages)


# ------------------------------------------------- suffix prefill (model)


def _ctx(Ctx, xp, total_tokens, mpps=80):
    pages = (total_tokens + PTOK - 1) // PTOK
    tables = np.full((1, 1, mpps), -1, np.int32)
    ntok = np.zeros((1, 1, mpps), np.int32)
    for i in range(pages):
        tables[0, 0, i] = i
        ntok[0, 0, i] = min(PTOK, total_tokens - i * PTOK)
    return Ctx(tables=xp(tables), ntok=xp(ntok),
               wpage=xp(np.asarray([[(total_tokens - 1) // PTOK]], np.int32)),
               wslot=xp(np.asarray([(total_tokens - 1) % PTOK], np.int32)),
               frame_pages=GEO_KW["frame_pages"])


def _t_full(lm, prompt, pools):
    T = len(prompt)
    toks = torch.zeros((1, -(-T // PTOK) * PTOK), dtype=torch.int32)
    toks[0, :T] = torch.from_numpy(prompt)
    logits, _, _ = lm.prefill({"tokens": toks}, pools,
                              _ctx(TCtx, torch.from_numpy, T + 1),
                              last_pos=torch.tensor([T - 1]))
    return logits


def _t_suffix(lm, prompt, P, pools, pk, pv):
    T = len(prompt)
    toks = torch.zeros((1, -(-T // PTOK) * PTOK - P), dtype=torch.int32)
    toks[0, :T - P] = torch.from_numpy(prompt[P:])
    logits, _, _ = lm.prefill({"tokens": toks}, pools,
                              _ctx(TCtx, torch.from_numpy, T + 1),
                              last_pos=torch.tensor([T - 1 - P]),
                              prefix_kv=(pk, pv), prefix_len=P)
    return logits


def test_lm_suffix_prefill_matches_reference():
    """Same weights, same cached prefix K/V, f32 pools: the port's suffix
    prefill against the reference's, logits and written pages."""
    jcfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    jlm, tlm = JLM(jcfg), TLM(tcfg)
    tlm.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(1)
    P = 3 * PTOK
    prompt = rng.integers(0, jcfg.vocab_size, P + 13).astype(np.int32)
    shape = jlm.pool_shapes(32, PTOK)[0].shape
    pk = rng.normal(size=(shape[0], 1, P, *shape[3:])).astype(np.float32)
    pv = rng.normal(size=pk.shape).astype(np.float32)
    T = len(prompt)
    toks = np.zeros((1, -(-T // PTOK) * PTOK - P), np.int32)
    toks[0, :T - P] = prompt[P:]
    lj, pools_j, _ = jlm.prefill(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(toks)},
        (jnp.zeros(shape), jnp.zeros(shape)),
        _ctx(JCtx, jnp.asarray, T + 1),
        last_pos=jnp.asarray([T - 1 - P], jnp.int32),
        prefix_kv=(jnp.asarray(pk), jnp.asarray(pv)), prefix_len=P)
    pools_t = (torch.zeros(shape), torch.zeros(shape))
    lt = _t_suffix(tlm, prompt, P, pools_t, torch.from_numpy(pk),
                   torch.from_numpy(pv))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    for a, b in zip(pools_t, pools_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
        assert not a[:, :P // PTOK].any()      # cached pages not rewritten


@pytest.fixture(scope="module")
def bf16_lm():
    cfg = t_smoke("qwen2.5-3b")
    assert cfg.dtype == "bfloat16"
    return cfg, TLM(cfg).init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("prefix_pages,len_a,len_b", [
    (2, 17, 9),          # test_prefix_cache.py:156's shapes
    (4, 3, 30),
    (62, 30, 41),        # the prompts span two row blocks, the suffix one
])
def test_suffix_prefill_bitwise_matches_full_prefill(bf16_lm, prefix_pages,
                                                     len_a, len_b):
    """Prefilling only the suffix against cached prefix K/V (written by a
    prompt of another padded length) reproduces the full prefill's logits
    and pool pages bitwise."""
    cfg, lm = bf16_lm
    rng = np.random.default_rng(prefix_pages)
    P = prefix_pages * PTOK
    prefix = rng.integers(0, cfg.vocab_size, P).astype(np.int32)
    prompt_a, prompt_b = (np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (len_a, len_b))
    if prefix_pages == 62:
        assert len(prompt_b) > PREFILL_ROWS > len(prompt_b) - P

    def pools():
        (shape, dtype), _ = lm.pool_shapes(96, PTOK)
        return torch.zeros(shape, dtype=dtype), torch.zeros(shape,
                                                            dtype=dtype)

    pools_a = pools()
    _t_full(lm, prompt_a, pools_a)
    L = pools_a[0].shape[0]
    pk, pv = (p[:, :prefix_pages].reshape(L, 1, P, *p.shape[3:])
              for p in pools_a)
    pools_ref = pools()
    logits_ref = _t_full(lm, prompt_b, pools_ref)
    warm = pools()
    for w, a in zip(warm, pools_a):
        w[:, :prefix_pages] = a[:, :prefix_pages]
    logits_warm = _t_suffix(lm, prompt_b, P, warm, pk, pv)
    assert torch.equal(logits_warm, logits_ref)
    n = -(-len(prompt_b) // PTOK)
    for ref, got in zip(pools_ref, warm):
        assert torch.equal(got[:, :n], ref[:, :n])


# ------------------------------------------------------- engine end-to-end


def _shared_prefix_requests(R, vocab, n=5, shared_tokens=40,
                            suffix_tokens=8, max_new=4, seed=0):
    """test_prefix_cache.py:214's requests, for class R."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_tokens).astype(np.int32)
    return [R(rid=i, tenant=i % 3, max_new=max_new, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, suffix_tokens).astype(np.int32)]))
            for i in range(n)]


def _run_waves(package, mode, *, prefix_cache=True, dtype="float32",
               params=None):
    """test_prefix_cache.py:227: two requests, drain, three more."""
    kw = dict(max_batch=4, max_seq=128, manager_kind="mosaic",
              prefix_cache=prefix_cache, fault_mode=mode,
              decode_window_us=1000.0)
    if package == "jax":
        cfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype=dtype)
        eng = JEngine(cfg, geometry=JGeo(**GEO_KW),
                      params=jax.tree.map(jnp.asarray, params), **kw)
        R = JRequest
    else:
        cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype=dtype)
        eng = TEngine(cfg, geometry=TGeo(**GEO_KW), device="cpu",
                      params=None if params is None
                      else params_from_jax(params), **kw)
        R = TRequest
    reqs = _shared_prefix_requests(R, cfg.vocab_size)
    for r in reqs[:2]:
        eng.submit(r)
    eng.run_until_drained(max_steps=300)
    for r in reqs[2:]:
        eng.submit(r)
    eng.run_until_drained(max_steps=600)
    assert all(r.done for r in reqs)
    eng.cache.check_invariants()
    assert eng.host.request_pages() == 0
    return eng, {r.rid: list(r.out) for r in reqs}


@pytest.fixture(scope="module")
def f32_params():
    cfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
    return jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode", ["sync", "async", "fused"])
def test_engine_prefix_cache_matches_reference(mode, f32_params):
    j_eng, j_tok = _run_waves("jax", mode, params=f32_params)
    t_eng, t_tok = _run_waves("torch", mode, params=f32_params)
    assert t_tok == j_tok
    for c in COUNTERS:
        assert getattr(t_eng.stats, c) == pytest.approx(
            getattr(j_eng.stats, c), rel=1e-12), c
    assert t_eng.stats.admit_lat_us == j_eng.stats.admit_lat_us
    assert t_eng.prefix.stats == j_eng.prefix.stats
    assert t_eng.host.stats == j_eng.host.stats
    for k, v in j_eng.dma.stats.items():
        assert t_eng.dma.stats[k] == pytest.approx(v, rel=1e-12), k
    s, ptok = t_eng.stats, PTOK
    assert s.prefix_hits >= 3 and s.prefix_reused_tokens >= 3 * 40
    assert s.admit_hits == s.prefix_hits and s.admit_colds == 2
    # Each faulted page crosses to the device once; the cached prefix also
    # crosses once more for the suffix's attention, counted apart.
    assert s.h2d_bytes == s.faults * t_eng.page_bytes
    assert s.prefix_h2d_bytes \
        == s.prefix_reused_tokens // ptok * t_eng.page_bytes
    assert s.faults >= s.prefix_reused_tokens // ptok
    assert s.gathers >= 1 and s.prefix_parked_pages > 0
    assert "prefix 3/2 hit/miss (120 tok reused)" in s.summary()
    if mode != "sync":
        assert s.prefix_fault_us > 0 and t_eng.dma.stats["park_jobs"] > 0


@pytest.fixture(scope="module")
def bf16_runs():
    return {(mode, on): _run_waves("torch", mode, prefix_cache=on,
                                   dtype="bfloat16")
            for mode in ("sync", "async", "fused") for on in (True, False)}


@pytest.mark.parametrize("mode", ["sync", "async", "fused"])
def test_port_prefix_cache_on_off_tokens_identical(mode, bf16_runs):
    (on, tok_on), (off, tok_off) = bf16_runs[mode, True], \
        bf16_runs[mode, False]
    assert tok_on == tok_off == bf16_runs["sync", False][1]
    assert on.stats.prefix_hits >= 3 and off.stats.prefix_hits == 0
    assert off.prefix is None and off.stats.prefix_misses == 0
    assert on.stats.prefill_tokens \
        == off.stats.prefill_tokens - on.stats.prefix_reused_tokens
    # The index outlives every request: only negative owners remain.
    assert len(on.prefix) >= 5
    assert all(o < 0 for o, _s, _v in on.host._pages)


def test_summary_without_prefix_traffic_has_no_prefix_part():
    assert "prefix" not in EngineStats().summary()
    s = EngineStats(prefix_hits=3, prefix_misses=1, prefix_reused_tokens=40)
    assert "prefix 3/1 hit/miss (40 tok reused)" in s.summary()


def test_chip_smoke_prefix_phase_on_cpu():
    """chip_smoke.py's phase 4b rehearsed at smoke width on the CPU: each
    run passes its checks, the cache hits on every second-wave request,
    and the four runs emit identical tokens.  Scheduling depends on token
    counts only, so the full-width run on the card does the same."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    cfg = t_smoke("qwen2.5-3b")
    tokens, stats = [], {}
    for mode, on in (("sync", True), ("async", True), ("fused", True),
                     ("async", False)):
        eng, reqs, counts, _wall = cs.serve_prefix(cfg, mode, on,
                                                   device="cpu")
        cs.check_prefix_run(cfg, mode, eng, reqs, counts)
        assert not any(counts.values())      # plain versions on the CPU
        tokens.append({r.rid: list(r.out) for r in reqs})
        stats[on] = eng.stats
    assert all(t == tokens[0] for t in tokens)
    assert stats[True].prefix_hits == 4
    assert stats[True].prefix_reused_tokens == 4 * cs.PREFIX_TOKENS
    assert stats[True].prefill_tokens == stats[False].prefill_tokens \
        - stats[True].prefix_reused_tokens
