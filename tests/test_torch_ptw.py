"""The port's translation model (``core/ptw.py``, ``core/tlb_sim.py``,
``core/workloads.py``) against the reference's.

* ``TranslationSim``: per-app cycles, retired instructions, faults and
  TLB hits, and the walker's walk and cycle totals, equal the reference's
  exactly, flat and radix, on the synthetic scattered and contiguous
  traces of tests/test_ptw.py and on traces built by the managers
  (``build_workload``, mosaic and gpu-mmu).
* ``TranslationMeter``: the same sequence of step accesses and splinters
  gives the same per-step counters and backlog in both packages.
* The engine's meter: on the f32 smoke config with bridged weights, the
  port's engine reports the reference engine's translation counters for
  flat and radix, and its tokens are identical with the meter off, flat
  and radix (the meter is observational), radix walking no more than
  flat.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import PoolGeometry as JGeo
from repro.core import ptw as jptw
from repro.core import tlb_sim as jsim
from repro.core import workloads as jwl
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.core import ptw as tptw
from repro_torch.core import tlb_sim as tsim
from repro_torch.core import workloads as twl
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from test_torch_parity_helpers import bridged

pytestmark = pytest.mark.ptw

TRANSLATION = ("translation_lookups", "translation_tlb_hits",
               "translation_walks", "translation_walk_cycles",
               "translation_queue_cycles", "translation_us")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(sim, seed, pages=600, n=1500, contiguous=False):
    """tests/test_ptw.py's synthetic trace, built with ``sim``'s AppTrace."""
    r = np.random.default_rng(seed)
    vpn = r.integers(0, pages, n).astype(np.int32)
    if contiguous:
        ppn = (vpn + 4 * pages).astype(np.int32)
    else:
        ppn = r.permutation(pages).astype(np.int32)[vpn]
    return sim.AppTrace(vpn=vpn, ppn=ppn, frame=(ppn // 8).astype(np.int32),
                        coalesced=np.zeros(n, np.int8), gap_cycles=100,
                        name=f"app{seed}")


def _run(sim, cfg_kw, traces):
    s = sim.TranslationSim(sim.SimConfig(**cfg_kw), traces)
    res = s.run()
    per_app = [(r.cycles, r.retired, r.faults, r.l1_hit) for r in res]
    totals = (s.total_walks(), s.total_walk_cycles()) \
        if cfg_kw.get("translation") == "radix" else (s.walker.walks,)
    return per_app, totals, s.link.faults


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("cfg_kw", [
    dict(translation="flat", mode="base", l1_large_entries=0,
         l2_large_entries=0),
    dict(translation="radix", paging=False),
    dict(translation="radix", coalesce_span=4, paging=False),
    dict(translation="flat", paging=False),
])
def test_translation_sim_matches_reference_on_synthetic_traces(cfg_kw,
                                                               contiguous):
    want = _run(jsim, cfg_kw, [_trace(jsim, s, contiguous=contiguous)
                               for s in (1, 2)])
    got = _run(tsim, cfg_kw, [_trace(tsim, s, contiguous=contiguous)
                              for s in (1, 2)])
    assert got == want


@pytest.mark.parametrize("manager", ["mosaic", "gpu-mmu"])
@pytest.mark.parametrize("translation", ["flat", "radix"])
def test_translation_sim_matches_reference_on_allocator_traces(manager,
                                                               translation):
    names = jwl.homogeneous_names("bfs", 2)
    assert twl.homogeneous_names("bfs", 2) == names
    runs = []
    for sim, wl in ((jsim, jwl), (tsim, twl)):
        traces, info = wl.build_workload(names, manager, seed=0,
                                         n_access=1200)
        runs.append((_run(sim, dict(translation=translation, paging=False),
                          traces),
                     [(t.vpn.tolist(), t.ppn.tolist(), t.frame.tolist(),
                       t.coalesced.tolist()) for t in traces]))
    assert runs[1] == runs[0]


def test_translation_meter_matches_reference_step_for_step():
    rng = np.random.default_rng(3)
    meters = [m.TranslationMeter("radix", span=4) for m in (jptw, tptw)]
    for step in range(40):
        tables = []
        for seq in range(3):
            n = int(rng.integers(4, 24))
            base = int(rng.integers(0, 200))
            ppn = [base + i if rng.random() < 0.8 else
                   int(rng.integers(0, 400)) for i in range(n)]
            tables.append(((seq, 0), seq % 2, ppn))
        outs = [m.step_access(step * 50.0, tables) for m in meters]
        assert outs[1] == outs[0]
        if step % 7 == 3:
            vpn = int(rng.integers(0, 8))
            for m in meters:
                m.splinter((1, 0), vpn)
        assert meters[1].backlog_us(step * 50.0) \
            == meters[0].backlog_us(step * 50.0)
    assert meters[1].summary() == meters[0].summary()


def _serve(package, translation):
    """tests/test_ptw.py's engine workload (three requests, tenants 0/1)
    on the f32 smoke config with bridged weights."""
    jcfg, _jlm, jparams, tlm = bridged("qwen2.5-3b")
    geo_kw = dict(page_tokens=8, frame_pages=4)
    kw = dict(max_batch=2, max_seq=64, decode_window_us=100.0,
              translation=translation)
    if package == "jax":
        eng = JEngine(jcfg, geometry=JGeo(**geo_kw), params=jparams, **kw)
        R = JRequest
    else:
        eng = TEngine(tlm.cfg, geometry=TGeo(**geo_kw), params=tlm,
                      device="cpu", **kw)
        R = TRequest
    rng = np.random.default_rng(0)
    reqs = [R(rid=i, tenant=i % 2,
              prompt=rng.integers(0, jcfg.vocab_size, 12 + 4 * i)
              .astype(np.int32), max_new=5) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, {r.rid: tuple(r.out) for r in reqs}


def test_engine_meter_is_observational_and_matches_reference():
    ports = {t: _serve("torch", t) for t in ("off", "flat", "radix")}
    toks = {t: out for t, (_e, out) in ports.items()}
    assert toks["off"] == toks["flat"] == toks["radix"]
    off, flat, radix = (ports[t][0].stats for t in ("off", "flat", "radix"))
    assert off.translation_lookups == 0
    assert flat.translation_lookups == radix.translation_lookups > 0
    assert radix.translation_walks <= flat.translation_walks
    assert ports["off"][0].translation_backlog_us() == 0.0
    for t in ("flat", "radix"):
        ref_eng, ref_out = _serve("jax", t)
        assert ref_out == toks[t]
        got = dataclasses.asdict(ports[t][0].stats)
        want = dataclasses.asdict(ref_eng.stats)
        assert {k: got[k] for k in TRANSLATION} \
            == {k: want[k] for k in TRANSLATION}, t
        assert ports[t][0].translation_backlog_us() \
            == ref_eng.translation_backlog_us()
        assert ports[t][0].translation_meter.summary() \
            == ref_eng.translation_meter.summary()
