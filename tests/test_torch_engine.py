"""The port's ServingEngine (sync fault-in) vs the reference's.

Both engines serve the f32 smoke config on the same weights (the
reference's ``LM.init`` bridged into the port) over the workloads of three
tests/test_serving.py scenarios, each with its default prefix cache on
(these prompts share no page, so admissions miss and completions park).
Greedy tokens must be identical and the modeled counters equal: both
packages make the same allocation, fault and compaction decisions with the
same copies of the core managers and link model.  The port runs its kernels' plain versions here (CPU tensors).
"""

import dataclasses
import sys
from pathlib import Path

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
from repro_torch.serving.engine import EngineStats
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.host_tier import HostPageStore as TStore
from repro_torch.serving.host_tier import PrefixIndex as TIndex

ROOT = Path(__file__).resolve().parents[1]
GEO_KW = dict(page_tokens=8, frame_pages=4, headroom=1.25,
              compact_threshold=0.4)
COUNTERS = ("faults", "fault_dmas", "bytes_in", "transfer_us", "swaps_out",
            "swaps_in", "compaction_copies", "coalesced_sum")
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8],
           [2, 7, 1, 8],
           [9, 9, 8, 2, 1, 0, 4, 5, 6, 7, 1, 2, 3],
           [11, 3, 5]]


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


def _requests(R, scenario, vocab):
    """The request lists of test_serving.py's scenarios, for class R."""
    if scenario in ("independence", "two_shards"):   # test_serving.py:47
        return [R(rid=i, tenant=i % 2, prompt=np.asarray(p, np.int32),
                  max_new=6) for i, p in enumerate(PROMPTS)]
    if scenario == "oversubscribed":         # test_serving.py:122-135
        rng = np.random.default_rng(0)
        reqs = []
        for i in range(10):
            T = int(rng.integers(24, 56))
            reqs.append(R(rid=i, tenant=i % 3,
                          prompt=rng.integers(0, vocab, T).astype(np.int32),
                          max_new=int(rng.integers(24, 40))))
        return reqs
    rng = np.random.default_rng(3)           # test_serving.py:157
    return [R(rid=i, tenant=i, prompt=rng.integers(0, vocab, T)
              .astype(np.int32), max_new=mn)
            for i, (T, mn) in enumerate([(20, 24), (5, 30), (7, 30)])]


ENGINE_KW = {
    "independence": dict(max_batch=3, max_seq=96),
    "two_shards": dict(max_batch=3, max_seq=96, n_shards=2),
    "oversubscribed": dict(max_batch=6, max_seq=96, oversubscription=2.0),
    "preempt": dict(max_batch=4, max_seq=96),
}


def _run(package, scenario, manager, weights, *, with_preempt=True):
    params_j, state_dict = weights
    if package == "jax":
        cfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
        eng = JEngine(cfg, geometry=JGeo(**GEO_KW), manager_kind=manager,
                      params=jax.tree.map(jax.numpy.asarray, params_j),
                      fault_mode="sync", **ENGINE_KW[scenario])
        R = JRequest
    else:
        cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
        eng = TEngine(cfg, geometry=TGeo(**GEO_KW), manager_kind=manager,
                      params=state_dict, fault_mode="sync", device="cpu",
                      **ENGINE_KW[scenario])
        R = TRequest
    reqs = _requests(R, scenario, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    if scenario == "preempt":
        for step in range(60):
            eng.step()
            if with_preempt and step in (3, 9):
                assert eng.preempt(0, hold=True)
                eng.cache.check_invariants()
                for _ in range(2):
                    eng.step()
                assert eng.release(0)
                eng.step()
            if all(r.done for r in reqs):
                break
    eng.run_until_drained(max_steps=2000)
    assert all(r.done for r in reqs)
    eng.cache.check_invariants()
    assert eng.host.request_pages() == 0
    return ({r.rid: list(r.out) for r in reqs},
            {c: getattr(eng.stats, c) for c in COUNTERS})


@pytest.mark.parametrize("scenario,manager", [
    ("independence", "mosaic"),
    ("two_shards", "mosaic"),     # frames striped over two sub-pools
    ("oversubscribed", "mosaic"),
    ("oversubscribed", "gpu-mmu"),
    ("preempt", "mosaic"),
])
def test_engine_matches_reference(scenario, manager, weights):
    tok_j, stats_j = _run("jax", scenario, manager, weights)
    tok_t, stats_t = _run("torch", scenario, manager, weights)
    assert tok_t == tok_j
    assert stats_t == stats_j
    if scenario == "oversubscribed":
        assert stats_t["swaps_out"] >= 1 and stats_t["faults"] >= 1
    if scenario == "preempt":
        assert stats_t["swaps_out"] >= 2 and stats_t["faults"] > 0


@pytest.mark.parametrize("scenario", ["independence", "oversubscribed"])
def test_port_outputs_independent_of_manager(scenario, weights):
    """Application transparency inside the port, bitwise."""
    mosaic, _ = _run("torch", scenario, "mosaic", weights)
    baseline, _ = _run("torch", scenario, "gpu-mmu", weights)
    assert mosaic == baseline


def test_port_preempted_request_resumes_token_identical(weights):
    plain, stats_plain = _run("torch", "preempt", "mosaic", weights,
                              with_preempt=False)
    swapped, stats_swap = _run("torch", "preempt", "mosaic", weights)
    assert stats_plain["swaps_out"] == 0 and stats_swap["swaps_out"] >= 2
    assert plain == swapped


def test_port_priority_arrival_displaces_lower_priority():
    """A high-priority arrival preempts a lower-priority active request
    instead of waiting (test_serving.py:203), and everyone finishes."""
    cfg = t_smoke("qwen2.5-3b")
    eng = TEngine(cfg, geometry=TGeo(**GEO_KW), max_batch=3, max_seq=96,
                  oversubscription=1.6, device="cpu")
    rng = np.random.default_rng(4)
    low = [TRequest(rid=i, tenant=0, priority=0, max_new=16,
                    prompt=rng.integers(0, cfg.vocab_size, 64)
                    .astype(np.int32)) for i in range(3)]
    for r in low:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    hi = TRequest(rid=99, tenant=1, priority=5, max_new=8,
                  prompt=rng.integers(0, cfg.vocab_size, 64)
                  .astype(np.int32))
    eng.submit(hi)
    for _ in range(4):
        eng.step()
        eng.cache.check_invariants()
    assert hi in eng.active or hi.done
    assert eng.stats.swaps_out >= 1
    eng.run_until_drained(max_steps=500)
    assert all(r.done for r in low + [hi])
    assert eng.host.request_pages() == 0


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_stream_exercises_paging_and_cac():
    """chip_smoke.py's stream, at smoke width with its geometry (64-token
    pages, 16-page frames), swaps, faults and runs CAC copies; its dual
    probe sees a coalesced frame; CAC moves pages coherently.  Scheduling
    depends on token counts only, so the full-width run does the same."""
    cs = _chip_smoke()
    cfg = t_smoke("qwen2.5-3b")
    eng = TEngine(cfg, geometry=TGeo(), max_batch=cs.MAX_BATCH,
                  max_seq=cs.MAX_SEQ, oversubscription=cs.OVERSUB,
                  device="cpu")
    events = cs.MainPathEvents(cfg)
    stream = cs.make_stream(cfg.vocab_size)
    cs.drive(eng, stream, events)
    s = eng.stats
    assert all(r.done and len(r.out) == r.max_new for _, r in stream)
    assert s.swaps_out >= 1 and s.faults >= 1 and s.compaction_copies >= 1
    assert events.probe_frames >= 1 and events.cac_checked


def test_chip_smoke_transparency_batches_match():
    """Without oversubscription both managers form the same decode batches
    on chip_smoke.py's stream, so their tokens are comparable on the card."""
    cs = _chip_smoke()
    cfg = t_smoke("qwen2.5-3b")
    runs = {}
    for kind in ("mosaic", "gpu-mmu"):
        eng = TEngine(cfg, geometry=TGeo(), max_batch=cs.MAX_BATCH,
                      max_seq=cs.MAX_SEQ, manager_kind=kind, device="cpu")
        stream = cs.make_stream(cfg.vocab_size)
        runs[kind] = (cs.drive(eng, stream),
                      {r.rid: list(r.out) for _, r in stream})
    assert runs["mosaic"] == runs["gpu-mmu"]


@pytest.mark.parametrize("kw,slice_name", [
    (dict(translation="radix"), "translation"),
    (dict(host=TStore()), "cluster"),
    (dict(prefix_index=TIndex(TStore(), GEO_KW["page_tokens"])), "cluster"),
    (dict(injector=FaultInjector()), "cluster"),
])
def test_unported_options_name_their_slice(kw, slice_name):
    """The options that once named the slice bringing them (the
    translation meter, the cluster tier) are ported: the engine takes
    each and holds what it was given."""
    eng = TEngine(t_smoke("qwen2.5-3b"), geometry=TGeo(**GEO_KW),
                  max_batch=2, max_seq=32, device="cpu", **kw)
    if slice_name == "translation":
        assert eng.translation_meter is not None
        assert eng.translation_meter.mode == kw["translation"]
    elif "host" in kw:
        assert eng.host is kw["host"]
    elif "prefix_index" in kw:
        assert eng.prefix is kw["prefix_index"]
    else:
        assert eng.injector is kw["injector"]
        assert eng.dma.injector is kw["injector"]


def test_bad_option_values_raise_value_error():
    with pytest.raises(ValueError, match="fault_mode"):
        TEngine(t_smoke("qwen2.5-3b"), geometry=TGeo(**GEO_KW), max_batch=2,
                max_seq=32, device="cpu", fault_mode="eager")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(t_smoke("qwen2.5-3b"), geometry=TGeo(**GEO_KW), max_batch=2,
                max_seq=32)


def test_summary_reports_measured_and_modeled_traffic():
    s = EngineStats(prefill_tokens=10, decode_tokens=5, decode_steps=5,
                    faults=3, fault_dmas=1, bytes_in=3 * 1024,
                    h2d_bytes=2 ** 20, h2d_s=0.002, swaps_out=1, swaps_in=1,
                    compaction_copies=2, wall_s=1.0)
    line = s.summary()
    assert line.startswith("15.0 tok/s")
    assert "faults 3 in 1 DMAs (3 KiB" in line
    assert "PCIe in 1.0 MiB 2.0 ms" in line
    assert "swaps 1/1 | CAC copies 2" in line


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", "qwen2.5-3b", "--smoke", "--requests", "3",
                "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[mosaic] 3 requests in" in out
    assert out.count("rid=") == 3


def test_serve_cli_cluster_with_translation_meter_on_cpu(capsys):
    """``--engines 2 --translation radix``: the cluster summary, one
    translation line per engine, and the single engine's tokens."""
    argv = ["--arch", "qwen2.5-3b", "--smoke", "--requests", "6",
            "--max-new", "4", "--translation", "radix", "--device", "cpu"]
    serve.main(argv)
    single = [line for line in capsys.readouterr().out.splitlines()
              if "rid=" in line]
    serve.main(argv + ["--engines", "2"])
    out = capsys.readouterr().out
    assert "[mosaic] 6 requests in" in out and "cluster steps" in out
    assert "cluster: 2 engines" in out and "router: 6 submitted" in out
    assert out.count("translation[radix]") == 2
    assert [line for line in out.splitlines() if "rid=" in line] == single
