"""The port's MoE block and moe-family LMs vs the reference's.

Inputs are drawn with numpy from a seed; weights come from the reference's
initialisers (``init_moe_params``, ``LM.init``) and are bridged into the
port.  Everything runs in float32 on the CPU (the kernels' plain versions)
at rtol/atol 1e-4, as tests/test_torch_models.py: the same math in another
framework sums the matmuls in another order (f32 rounding ~1e-7 relative,
amplified through the layers and the unembedding).  Routing (experts,
capacity positions, drops) and engine tokens and counters are exact.

Three reference behaviours are pinned: top-k ties go to the lower expert
index (``jax.lax.top_k``), overflow entries past the capacity are dropped,
and the capacity is a function of the whole forward's length, so page
padding that the engine appends to a prompt takes capacity slots.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models import moe as jmoe
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import list_archs
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

from test_torch_parity_helpers import (
    GEO_KW,
    bridged,
    check_engine_matches_reference,
    frontend_batch,
)

F32 = dict(rtol=1e-4, atol=1e-4)
NP, MPPS, PTOK = 32, 12, 8
MOE_ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")


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


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32))


def _cfgs(arch, **moe_kw):
    """(reference cfg, port cfg) of ``arch``'s smoke config in f32, with
    MoE fields overridden by ``moe_kw``."""
    out = []
    for smoke in (j_smoke, t_smoke):
        cfg = dataclasses.replace(smoke(arch), dtype="float32")
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _moe_params(jcfg, seed=0):
    """One layer of the reference's ``init_moe_params`` as numpy arrays."""
    tree = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg, 1)
    return {k: np.array(v[0]) for k, v in tree.items()}


def _both(jcfg, tcfg, p, x):
    """moe_block of both packages on numpy weights and input."""
    yj, auxj = jmoe.moe_block(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    yt, auxt = tmoe.moe_block(tcfg, tp, torch.from_numpy(x))
    return (yj, auxj), (yt, auxt), tp


# ------------------------------------------------------------------ block


@pytest.mark.parametrize("arch,moe_kw,drops", [
    ("deepseek-v2-lite-16b", {}, False),       # shared experts, cf 4
    ("dbrx-132b", {}, False),                  # routed only
    ("deepseek-v2-lite-16b", {"capacity_factor": 0.75}, True),
    ("dbrx-132b", {"capacity_factor": 0.5}, True),
])
def test_moe_block_matches_reference(arch, moe_kw, drops):
    """Output and load-balance loss of one MoE layer on two 24-token rows;
    with a small capacity factor the experts overflow and drop entries."""
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    p = _moe_params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    (yj, auxj), (yt, auxt), tp = _both(jcfg, tcfg, p, x)
    _close(yt, yj)
    _close(auxt, auxj)
    keep = tmoe.route(tcfg, tp["router"], torch.from_numpy(x))[4]
    assert bool((~keep).any()) == drops


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 2)
    vt, it = tmoe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_moe_block_forced_tie_routes_like_reference():
    """A zero router makes every expert's probability exactly 1 / E: both
    packages send every token to experts 0 and 1."""
    jcfg, tcfg = _cfgs("dbrx-132b")
    p = _moe_params(jcfg, seed=2)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(3).normal(
        size=(1, 16, jcfg.d_model)).astype(np.float32)
    (yj, _), (yt, _), tp = _both(jcfg, tcfg, p, x)
    _close(yt, yj)
    sel = tmoe.route(tcfg, tp["router"], torch.from_numpy(x))[2]
    assert (sel == torch.tensor([0, 1])).all()


def test_page_padding_takes_moe_capacity_in_both_packages():
    """The engine pads a 13-token prompt to 16 with token 0 and prefills
    all 16 rows (``repro/serving/engine.py:1619-1627``).  The capacity is
    then ceil(16 · 2 / 4 · 1.0) = 8 instead of 7: with every token's first
    choice expert 0, row 7 keeps its expert-0 slot only in the padded
    forward, and the pad rows hold slots of their second expert.  Both
    packages agree on the padded and on the unpadded forward."""
    jcfg, tcfg = _cfgs("dbrx-132b", capacity_factor=1.0)
    rng = np.random.default_rng(4)
    p = _moe_params(jcfg, seed=4)
    p["router"][0, 0] = 10.0                  # feature 0 votes for expert 0
    real = rng.normal(size=(13, jcfg.d_model)).astype(np.float32)
    pad = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    real[:, 0] = pad[0] = 3.0
    padded = np.concatenate([real, np.tile(pad, (3, 1))])[None]
    outs = {}
    for name, x in (("padded", padded), ("exact", real[None])):
        (yj, _), (yt, _), tp = _both(jcfg, tcfg, p, x)
        _close(yt, yj)
        outs[name] = (yt, tmoe.route(tcfg, tp["router"], torch.from_numpy(x)))
    (y_pad, r_pad), (y_exact, r_exact) = outs["padded"], outs["exact"]
    assert (r_pad[5], r_exact[5]) == (8, 7)
    assert (r_pad[2][0, :, 0] == 0).all()
    assert bool(r_pad[4][0, 7, 0]) and not bool(r_exact[4][0, 7, 0])
    assert bool(r_pad[4][0, 13:, 1].any())     # pad rows hold slots
    torch.testing.assert_close(y_pad[0, :7], y_exact[0, :7], **F32)
    assert float((y_pad[0, 7] - y_exact[0, 7]).abs().max()) > 1e-3


def test_port_moe_init_draws_reference_distributions():
    """The port's own init (per-layer draws from a torch.Generator) has the
    reference's fan-in scales: d for router, gates and ups; d_expert for
    the downs."""
    cfg = dataclasses.replace(t_smoke("dbrx-132b"), dtype="float32",
                              d_model=256)
    p = tmoe.MoEParams(cfg, 2, torch.float32, "cpu")
    p.init_(torch.Generator().manual_seed(0))
    for name, fan in (("router", 256), ("w_gate", 256), ("w_down", 96)):
        w = getattr(p, name)
        assert w.abs().max() <= 3 / fan ** 0.5 + 1e-6
        assert abs(float(w.std()) * fan ** 0.5 - 0.987) < 0.05
    assert not torch.equal(p.w_up[0], p.w_up[1])


# ------------------------------------------------------------------ LM


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_prefill_and_decode_match_reference(arch):
    """Prefill of a 13-token prompt padded to two pages, then two decode
    steps: logits and both pools against the reference's; pool shapes
    (MLA: latent pools) and the weight tree (``decoder_prefix`` for
    deepseek's dense first layer) are the reference's."""
    jcfg, jlm, jparams, tlm = bridged(arch)
    assert ("decoder_prefix" in jparams) == hasattr(tlm, "decoder_prefix")
    jshapes = [s.shape for s in jlm.pool_shapes(NP, PTOK)]
    tshapes = [s for s, _ in tlm.pool_shapes(NP, PTOK)]
    assert tshapes == jshapes
    pj = tuple(jnp.zeros(s, jnp.float32) for s in jshapes)
    pt = tuple(torch.zeros(s) for s in tshapes)
    jc, tc = JCache(JGeo(**GEO_KW), NP, 1), TCache(TGeo(**GEO_KW), NP, 1)
    rng = np.random.default_rng(2)
    T = 13
    for c in (jc, tc):
        c.allocate(0, T)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :T] = rng.integers(0, jcfg.vocab_size, T)
    lj, pj, sj = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, pj,
                             jc.pack_ctx([0], MPPS),
                             last_pos=jnp.asarray([T - 1]))
    lt, pt, st = tlm.prefill({"tokens": torch.from_numpy(toks)}, pt,
                             tc.pack_ctx([0], MPPS),
                             last_pos=torch.tensor([T - 1]))
    _close(lt, lj)
    assert st == {} and sj == {}
    nxt = int(np.argmax(_np(lj)[0]))
    for _ in range(2):
        for c in (jc, tc):
            c.append(0)
        pos = np.array([jc.seq_tokens[0] - 1], np.int32)
        lj, pj, _ = jlm.decode_step(jparams, jnp.asarray([nxt]),
                                    jnp.asarray(pos), pj,
                                    jc.pack_ctx([0], MPPS))
        lt, pt, _ = tlm.decode_step(torch.tensor([nxt], dtype=torch.int32),
                                    torch.from_numpy(pos), pt,
                                    tc.pack_ctx([0], MPPS))
        _close(lt, lj)
        nxt = int(np.argmax(_np(lj)[0]))
    for a, b in zip(pt, pj):
        _close(a, b)


def _smoke_lm(arch):
    """The port's f32 smoke LM of ``arch`` with its own seeded weights."""
    cfg = dataclasses.replace(t_smoke(arch), dtype="float32")
    return TLM(cfg).init_weights(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", list_archs())
def test_prefill_decode_matches_full_forward(arch):
    """tests/test_smoke_archs.py's check over all ten archs of the port:
    prefill T tokens, then decode two, gives the logits of one prefill
    over all T + 2 tokens at its last real position.  Pool writes take
    whole pages, so T is a page multiple and the full prefill is
    right-padded to one (the smoke MoE configs' capacity factor 4 drops
    no token at either length).  vlm runs the same random patch
    embeddings in front of both (its pool holds them, and decode positions
    count them); encdec encodes the same random source frames in both."""
    lm = _smoke_lm(arch)
    cfg = lm.cfg
    rng = np.random.default_rng(3)
    T, B = 24, 2
    toks = rng.integers(0, cfg.vocab_size, (B, T + 2)).astype(np.int32)
    frontend = {k: torch.from_numpy(v) for k, v in
                frontend_batch(cfg, toks).items() if k != "tokens"}
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0

    def pools():
        shapes = lm.pool_shapes(NP, PTOK, dtype=torch.float32)
        return None if shapes is None else tuple(torch.zeros(s)
                                                 for s, _ in shapes)
    cache = TCache(TGeo(**GEO_KW), NP, 1)
    for b in range(B):
        cache.allocate(b, n_prefix + T)
    _, pl, state = lm.prefill(
        {"tokens": torch.from_numpy(toks[:, :T]), **frontend}, pools(),
        cache.pack_ctx([0, 1], MPPS))
    for i in range(2):
        for b in range(B):
            cache.append(b)
        logits, pl, state = lm.decode_step(
            torch.from_numpy(toks[:, T + i]),
            torch.full((B,), n_prefix + T + i), pl,
            cache.pack_ctx([0, 1], MPPS), state)
    full_cache = TCache(TGeo(**GEO_KW), NP, 1)
    for b in range(B):
        full_cache.allocate(b, n_prefix + T + 2)
    padded = np.zeros((B, T + PTOK), np.int32)
    padded[:, :T + 2] = toks
    full, _, _ = lm.prefill(
        {"tokens": torch.from_numpy(padded), **frontend}, pools(),
        full_cache.pack_ctx([0, 1], MPPS), last_pos=torch.full((B,), T + 1))
    torch.testing.assert_close(logits, full, **F32)


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_dbrx_engine_matches_reference(mode):
    check_engine_matches_reference("dbrx-132b", mode)


def test_chip_smoke_moe_phase_on_cpu():
    """chip_smoke.py's phase 4f rehearsed at smoke width on the CPU
    (plain versions): the first four requests complete in sync without
    the prefix cache."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = dataclasses.replace(t_smoke(chip_smoke.MOE_ARCH), dtype="float32")
    eng, stream, counts, _wall = chip_smoke.serve_stream(
        cfg, "sync", chip_smoke.MOE_REQUESTS, device="cpu")
    assert len(stream) == chip_smoke.MOE_REQUESTS
    chip_smoke.check_stream_run(cfg, "moe:sync", eng, stream, counts)
    assert all(v == 0 for v in counts.values())
