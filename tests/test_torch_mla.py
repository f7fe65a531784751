"""The port's Multi-head Latent Attention and its deepseek-v2-lite serving
vs the reference's.

Smoke configs in float32, weights from the reference's initialisers
bridged into the port, inputs drawn with numpy from a seed; the port runs
its kernels' plain versions (CPU tensors).  Tolerances: rtol/atol 1e-4 for
block outputs, logits and the latent pools (the same math in another
framework sums the matmuls in another order: f32 rounding ~1e-7
relative, amplified through the layers); engine tokens and modeled
counters exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models import mla as jmla
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models import mla as tmla
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

from test_torch_parity_helpers import (
    GEO_KW,
    bridged,
    check_engine_matches_reference,
)

F32 = dict(rtol=1e-4, atol=1e-4)
NP, MPPS, PTOK = 32, 12, 8
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions' tiny tensors otherwise
    spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _layer(seed=0):
    """(reference cfg, port cfg, one layer of ``init_mla_params`` as jax
    and torch dicts)."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="float32")
    tree = jmla.init_mla_params(jax.random.PRNGKey(seed), jcfg, 1)
    p = {k: np.array(v[0]) for k, v in tree.items()}
    # A kv_norm away from 1 so the latent's norm weight is exercised.
    p["kv_norm"] = np.random.default_rng(seed).uniform(
        0.5, 1.5, p["kv_norm"].shape).astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_mla_block_prefill_matches_reference():
    """Expanded causal attention over 21 tokens at positions 5..25 (dh 24,
    dh_v 16 at smoke width): the block output and the latent payloads the
    pools receive ([latent ‖ k_rope] and the latent, one KV head)."""
    jcfg, tcfg, jp, tp = _layer()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(5 + np.arange(21), (2, 21)).astype(np.int32)
    oj, pay_j = jmla.mla_block_train(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos))
    ot, pay_t = tmla.mla_block_prefill(tcfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(pos))
    _close(ot, oj)
    m = tcfg.mla
    assert pay_t["k"].shape == (2, 21, 1, m.kv_lora_rank
                                + m.qk_rope_head_dim)
    assert pay_t["v"].shape == (2, 21, 1, m.kv_lora_rank)
    for k in ("k", "v"):
        _close(pay_t[k], pay_j[k])


def test_mla_block_decode_matches_reference():
    """Absorbed decode of two rows over latent pools holding 19 and 6
    cached tokens (random payloads): the block output and both pools after
    this step's write, for two steps."""
    jcfg, tcfg, jp, tp = _layer(seed=2)
    m = tcfg.mla
    rng = np.random.default_rng(3)
    kd, vd = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
    kpool = rng.normal(size=(NP, PTOK, 1, kd)).astype(np.float32)
    vpool = rng.normal(size=(NP, PTOK, 1, vd)).astype(np.float32)
    pj = (jnp.asarray(kpool), jnp.asarray(vpool))
    pt = (torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy()))
    jc, tc = JCache(JGeo(**GEO_KW), NP, 1), TCache(TGeo(**GEO_KW), NP, 1)
    for c in (jc, tc):
        c.allocate(0, 19)
        c.allocate(1, 6)
    for _ in range(2):
        for c in (jc, tc):
            c.append(0)
            c.append(1)
        pos = np.array([jc.seq_tokens[0] - 1, jc.seq_tokens[1] - 1],
                       np.int32)
        x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        oj, kj, vj = jmla.mla_block_decode(
            jcfg, jp, jnp.asarray(x), jnp.asarray(pos), *pj,
            jc.pack_ctx([0, 1], MPPS))
        pj = (kj, vj)
        ot = tmla.mla_block_decode(tcfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), *pt,
                                   tc.pack_ctx([0, 1], MPPS))
        _close(ot, oj)
        for a, b in zip(pt, pj):
            _close(a, b)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_deepseek_engine_matches_reference(mode):
    """The port's ServingEngine against the reference's on the same
    weights over latent pools: greedy tokens, swaps and fault-ins, modeled
    µs with ``decode_window_us`` set (test_torch_moe's stream)."""
    check_engine_matches_reference(ARCH, mode)


def test_engine_refuses_fused_and_prefix_cache_for_mla():
    """As the reference: fused decode cannot stage latent pages, and the
    moe family has no prefix cache.  A page holds K (576 wide at full
    width) and V (512) latent payloads of every layer; its bytes equal the
    reference's."""
    jcfg, _jlm, jparams, tlm = bridged(ARCH)
    kw = dict(geometry=TGeo(**GEO_KW), max_batch=2, max_seq=64)
    with pytest.raises(ValueError, match="not MLA"):
        TEngine(tlm.cfg, fault_mode="fused", device="cpu", **kw)
    with pytest.raises(ValueError):
        JEngine(jcfg, geometry=JGeo(**GEO_KW), max_batch=2, max_seq=64,
                params=jparams, fault_mode="fused")
    eng = TEngine(tlm.cfg, params=tlm.state_dict(), device="cpu", **kw)
    ref = JEngine(jcfg, geometry=JGeo(**GEO_KW), max_batch=2, max_seq=64,
                  params=jparams)
    assert not eng.prefix_supported and eng.prefix is None
    m = tlm.cfg.mla
    L = tlm.cfg.n_layers
    assert eng.page_bytes == ref.page_bytes == L * PTOK * (
        2 * m.kv_lora_rank + m.qk_rope_head_dim) * 2
    k, v = eng.pools
    assert k.shape[-2:] == (1, m.kv_lora_rank + m.qk_rope_head_dim)
    assert v.shape[-2:] == (1, m.kv_lora_rank)


def test_chip_smoke_mla_phase_on_cpu():
    """chip_smoke.py's phase 4e rehearsed at smoke width on the CPU (plain
    versions): phase 4's stream and step hook (dual-granularity probe over
    the latent pools, a partial deallocation that CAC compacts) in sync
    and async; the stream swaps and faults, the modes agree on every
    token, and nothing parks."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = dataclasses.replace(t_smoke(chip_smoke.MLA_ARCH), dtype="float32")
    tokens = {}
    for mode in chip_smoke.SSM_MODES:
        eng, stream, events, counts, _wall = chip_smoke.serve_mode(
            cfg, mode, device="cpu")
        chip_smoke.check_mode_run(cfg, mode, eng, stream, events, counts)
        assert all(v == 0 for v in counts.values())
        tokens[mode] = [r.out for _, r in stream]
    assert tokens["async"] == tokens["sync"]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_chip_smoke_lm_agreement_on_cpu(arch):
    """chip_smoke.py's card-vs-CPU agreement of phase 4e rehearsed with
    both runs on the CPU, in the smoke config's bf16: the second run
    replays the first one's expert choices (its own are the same) for
    every routed token of the prompt and the two steps, and the two runs
    agree to the bit."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models import moe
    top_k = moe.top_k
    cfg = t_smoke(arch)
    agree, routed, err = chip_smoke.lm_agreement(cfg, "cpu")
    moe_layers = cfg.n_layers - cfg.moe.first_dense
    assert (agree, routed, err) == (1.0, moe_layers * (128 + 2), 0.0)
    assert moe.top_k is top_k
