"""Helpers shared by the moe and MLA parity tests (test_torch_moe.py,
test_torch_mla.py); the module holds no tests.

Both test files serve a smoke config through the reference's ServingEngine
and the port's on the same weights (the reference's ``LM.init`` bridged
into the port through ``params_from_jax``) and compare greedy tokens and
the modeled counters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models.lm import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

GEO_KW = dict(page_tokens=8, frame_pages=4)
COUNTERS = ("faults", "fault_dmas", "bytes_in", "transfer_us",
            "fault_exposed_us", "fault_hidden_us", "prefetch_hits",
            "prefetch_misses", "prefetch_wasted", "evict_pages", "evict_dmas",
            "bytes_out", "evict_us", "swaps_out", "swaps_in",
            "compaction_copies", "prefill_tokens", "decode_tokens",
            "decode_steps")
ENGINE_KW = dict(max_batch=3, max_seq=160, oversubscription=3.0,
                 decode_window_us=50.0)

_BRIDGED = {}


def bridged(arch):
    """(reference cfg, reference LM, its params, port LM on the same
    weights) in f32, built once per arch and process."""
    if arch not in _BRIDGED:
        jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(t_smoke(arch), dtype="float32")
        params = jax.tree.map(np.asarray,
                              JLM(jcfg).init(jax.random.PRNGKey(0)))
        tlm = TLM(tcfg)
        tlm.load_state_dict(params_from_jax(params), strict=True)
        _BRIDGED[arch] = (jcfg, JLM(jcfg), jax.tree.map(jnp.asarray, params),
                          tlm)
    return _BRIDGED[arch]


def serve(package, arch, mode):
    """Six requests (prompts of 40 + 11 i tokens, request 4 at priority 1);
    four arrive first, two at step 3.  Returns (tokens, stats)."""
    jcfg, _jlm, jparams, tlm = bridged(arch)
    if package == "jax":
        eng = JEngine(jcfg, geometry=JGeo(**GEO_KW), params=jparams,
                      fault_mode=mode, **ENGINE_KW)
        R = JRequest
    else:
        eng = TEngine(tlm.cfg, geometry=TGeo(**GEO_KW),
                      params=tlm.state_dict(), fault_mode=mode, device="cpu",
                      **ENGINE_KW)
        R = TRequest
    rng = np.random.default_rng(0)
    reqs = [R(rid=i, tenant=i % 3, max_new=12, priority=int(i == 4),
              prompt=rng.integers(0, jcfg.vocab_size, 40 + 11 * i)
              .astype(np.int32)) for i in range(6)]
    for r in reqs[:4]:
        eng.submit(r)
    for step in range(400):
        if step == 3:
            for r in reqs[4:]:
                eng.submit(r)
        eng.step()
        if all(r.done for r in reqs):
            break
    assert all(r.done for r in reqs)
    return [list(r.out) for r in reqs], eng.stats


def check_engine_matches_reference(arch, mode):
    """Greedy tokens and the modeled counters (µs included, with
    ``decode_window_us`` set) equal the reference's; the stream swaps out
    and faults pages back in; no prefix cache for the moe family."""
    tok_j, st_j = serve("jax", arch, mode)
    tok_t, st_t = serve("torch", arch, mode)
    assert tok_t == tok_j
    for c in COUNTERS:
        assert getattr(st_t, c) == getattr(st_j, c), c
    assert st_t.swaps_out >= 1 and st_t.faults >= 1
    assert st_t.prefix_hits == st_t.prefix_parked_pages == 0
    if mode == "async":
        assert st_t.prefetch_hits > 0
