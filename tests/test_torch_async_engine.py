"""The port's ServingEngine in async fault-in vs the reference's.

Both engines serve the f32 smoke config on the same weights (the
reference's ``LM.init`` bridged into the port), 2x oversubscribed, with a
fixed modeled decode window so that the modeled µs come from the same
numpy DMA timeline in both packages.  Greedy tokens must be identical and
the modeled counters equal.  The reference runs with ``prefix_cache=False``
(its default parks finished prompts on the outbound lanes, which the port
cannot do before the prefix-cache slice).  Inside the port, tokens are
identical across sync, async and fused under both managers.  The port runs
its kernels' plain versions here (CPU tensors).  The fused mode's
counterparts are in tests/test_torch_fused_engine.py, which shares this
file's helpers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models.lm import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.launch import serve
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

GEO_KW = dict(page_tokens=8, frame_pages=4, compact_threshold=0.4)
WINDOW_US = 2.0       # tight: transfers outlive it, so every bucket fills
COUNTERS = ("faults", "fault_dmas", "bytes_in", "transfer_us",
            "fault_exposed_us", "fault_hidden_us", "prefetch_hits",
            "prefetch_misses", "prefetch_wasted", "evict_pages", "evict_dmas",
            "bytes_out", "evict_us", "swaps_out", "swaps_in",
            "compaction_copies", "fused_ready_pages", "fused_drained_pages",
            "fused_tail_us")
# test_async_dma.py:134 (10 requests) and test_fused_decode.py:212 (8).
WORKLOADS = {"async_dma": 10, "fused_decode": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain versions run on tiny tensors here: one intra-op
    thread keeps them from spinning against the other test workers'
    threads (a parallel run is otherwise many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
    params = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(0)))
    return params, params_from_jax(params)


def _requests(R, vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [R(rid=i, tenant=i % 3,
              prompt=rng.integers(0, vocab, int(rng.integers(24, 56)))
              .astype(np.int32),
              max_new=int(rng.integers(24, 40))) for i in range(n)]


def _engine(package, mode, weights, *, manager="mosaic", max_batch=6,
            window=WINDOW_US):
    params_j, state_dict = weights
    kw = dict(max_batch=max_batch, max_seq=96, manager_kind=manager,
              oversubscription=2.0, fault_mode=mode, decode_window_us=window)
    if package == "jax":
        cfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
        return cfg, JEngine(cfg, geometry=JGeo(**GEO_KW), prefix_cache=False,
                            params=jax.tree.map(jax.numpy.asarray, params_j),
                            **kw)
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
    return cfg, TEngine(cfg, geometry=TGeo(**GEO_KW), params=state_dict,
                        device="cpu", **kw)


def _serve(package, mode, weights, n, **kw):
    cfg, eng = _engine(package, mode, weights, **kw)
    reqs = _requests(JRequest if package == "jax" else TRequest,
                     cfg.vocab_size, n)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=2000)
    assert all(r.done for r in reqs)
    eng.cache.check_invariants()
    assert eng.host.request_pages() == 0
    return eng, {r.rid: list(r.out) for r in reqs}


def check_matches_reference(mode, workload, weights):
    """Tokens identical and modeled counters equal to the reference's."""
    n = WORKLOADS[workload]
    j_eng, j_tok = _serve("jax", mode, weights, n)
    t_eng, t_tok = _serve("torch", mode, weights, n)
    assert t_tok == j_tok
    for c in COUNTERS:
        assert getattr(t_eng.stats, c) == pytest.approx(
            getattr(j_eng.stats, c), rel=1e-12), c
    s = t_eng.stats
    assert s.faults > 0 and s.prefetch_hits > 0 and s.fault_hidden_us > 0
    assert s.faults == s.prefetch_hits + s.prefetch_misses
    # Each faulted page crosses to the device exactly once.
    assert s.h2d_bytes == s.faults * t_eng.page_bytes
    if mode == "fused":
        assert s.fused_ready_pages + s.fused_drained_pages > 0
        assert s.fused_steps > 0
        assert s.fault_exposed_us == pytest.approx(s.fused_tail_us)
        assert "fused" in s.summary()


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_async_engine_matches_reference(workload, weights):
    check_matches_reference("async", workload, weights)


@pytest.mark.parametrize("manager", ["mosaic", "gpu-mmu"])
def test_port_tokens_identical_across_fault_modes(manager, weights):
    """Application transparency inside the port, bitwise: the fault mode
    changes when pages move and where decode reads them, never a token."""
    outs = {}
    for mode in ("sync", "async", "fused"):
        eng, outs[mode] = _serve("torch", mode, weights, 10, manager=manager,
                                 window=None if mode == "sync" else WINDOW_US)
        assert eng.stats.faults > 0
    assert outs["async"] == outs["sync"]
    assert outs["fused"] == outs["sync"]


def test_default_fault_mode_is_async_as_in_reference(capsys):
    eng = TEngine(t_smoke("qwen2.5-3b"), geometry=TGeo(**GEO_KW),
                  max_batch=2, max_seq=32, device="cpu")
    assert eng.fault_mode == "async" and eng.duplex
    serve.main(["--arch", "qwen2.5-3b", "--smoke", "--requests", "3",
                "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[mosaic] 3 requests in" in out
    assert "prefetch 0/0/0 hit/miss/wasted" in out
