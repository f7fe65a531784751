"""Helpers shared by the parity tests of the moe, MLA, vlm, encdec and
dense architectures (test_torch_moe.py, test_torch_mla.py,
test_torch_vlm.py, test_torch_encdec.py, test_torch_dense_archs.py); the
module holds no tests.

The test files serve a smoke config through the reference's ServingEngine
and the port's on the same weights (the reference's ``LM.init`` bridged
into the port through ``params_from_jax``) and compare greedy tokens and
the modeled counters exactly; ``check_lm_matches_reference`` holds the
port's LM against the reference's on a prefill and two decode steps, with
random frontend embeddings where the family takes them, at rtol/atol
1e-4 (f32: the same math in another framework sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models.lm import LM as JLM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

GEO_KW = dict(page_tokens=8, frame_pages=4)
COUNTERS = ("faults", "fault_dmas", "bytes_in", "transfer_us",
            "fault_exposed_us", "fault_hidden_us", "prefetch_hits",
            "prefetch_misses", "prefetch_wasted", "evict_pages", "evict_dmas",
            "bytes_out", "evict_us", "swaps_out", "swaps_in",
            "compaction_copies", "prefill_tokens", "decode_tokens",
            "decode_steps")
ENGINE_KW = dict(max_batch=3, max_seq=160, oversubscription=3.0,
                 decode_window_us=50.0)
F32 = dict(rtol=1e-4, atol=1e-4)

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
    and faults pages back in; only the dense family parks prompts in the
    prefix cache (the stream shares no prefix, so nothing hits).
    Returns the port's tokens."""
    tok_j, st_j = serve("jax", arch, mode)
    tok_t, st_t = serve("torch", arch, mode)
    assert tok_t == tok_j
    for c in COUNTERS + ("prefix_hits", "prefix_parked_pages"):
        assert getattr(st_t, c) == getattr(st_j, c), c
    assert st_t.swaps_out >= 1 and st_t.faults >= 1
    assert st_t.prefix_hits == 0
    dense = bridged(arch)[0].family == "dense"
    assert (st_t.prefix_parked_pages > 0) == dense
    if mode == "async":
        assert st_t.prefetch_hits > 0
    return tok_t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32))


def frontend_batch(cfg, tokens, seed=7):
    """{"tokens"} plus, where the family takes them, random frontend
    embeddings from ``seed`` (vlm: patch_embeds [B, P, d]; encdec:
    src_embeds [B, S, d]), as numpy arrays."""
    rng = np.random.default_rng(seed)
    B = tokens.shape[0]
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(
            size=(B, cfg.encdec.source_len, cfg.d_model)).astype(np.float32)
    return batch


def check_lm_matches_reference(arch, T=13, n_pages=32, mpps=12):
    """Prefill of a ``T``-token prompt padded to a page multiple, then two
    decode steps, in the reference and the port on the same weights and
    inputs: logits, both pools and the decode state (encdec's cross K/V)
    within F32.  vlm's pools hold its frontend tokens in front of the
    prompt."""
    jcfg, jlm, jparams, tlm = bridged(arch)
    jshapes = [s.shape for s in jlm.pool_shapes(n_pages, GEO_KW[
        "page_tokens"])]
    tshapes = [s for s, _ in tlm.pool_shapes(n_pages, GEO_KW["page_tokens"])]
    assert tshapes == jshapes
    pj = tuple(jnp.zeros(s, jnp.float32) for s in jshapes)
    pt = tuple(torch.zeros(s) for s in tshapes)
    jc, tc = JCache(JGeo(**GEO_KW), n_pages, 1), TCache(TGeo(**GEO_KW),
                                                        n_pages, 1)
    n_prefix = jcfg.frontend_tokens if jcfg.family == "vlm" else 0
    for c in (jc, tc):
        c.allocate(0, n_prefix + T)
    ptok = GEO_KW["page_tokens"]
    rng = np.random.default_rng(2)
    toks = np.zeros((1, -(-T // ptok) * ptok), np.int32)
    toks[0, :T] = rng.integers(0, jcfg.vocab_size, T)
    batch = frontend_batch(jcfg, toks)
    lj, pj, sj = jlm.prefill(jparams, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, pj,
                             jc.pack_ctx([0], mpps),
                             last_pos=jnp.asarray([T - 1]))
    lt, pt, st = tlm.prefill({k: torch.from_numpy(v)
                              for k, v in batch.items()}, pt,
                             tc.pack_ctx([0], mpps),
                             last_pos=torch.tensor([T - 1]))
    close(lt, lj)
    assert sorted(st) == sorted(sj)
    for k in st:
        close(st[k], sj[k])
    nxt = int(np.argmax(_np(lj)[0]))
    for _ in range(2):
        for c in (jc, tc):
            c.append(0)
        pos = np.array([jc.seq_tokens[0] - 1], np.int32)
        lj, pj, sj = jlm.decode_step(jparams, jnp.asarray([nxt]),
                                     jnp.asarray(pos), pj,
                                     jc.pack_ctx([0], mpps), sj)
        lt, pt, st = tlm.decode_step(torch.tensor([nxt], dtype=torch.int32),
                                     torch.from_numpy(pos), pt,
                                     tc.pack_ctx([0], mpps), st)
        close(lt, lj)
        nxt = int(np.argmax(_np(lj)[0]))
    for a, b in zip(pt, pj):
        close(a, b)
    return tlm
