"""The port's model code vs the reference's, on the same inputs and weights.

Inputs are drawn with numpy from a seed; weights come from the reference's
``LM.init`` through ``repro_torch.bridge.params_from_jax``.  Tolerances:

* float32: rtol/atol 1e-4 — the same math in another framework sums the
  matmuls and reductions in another order (f32 rounding ~1e-7 relative,
  amplified through two layers and the unembedding);
* bfloat16: rtol/atol 2e-2 — bf16 rounds at different places in the two
  frameworks (one bf16 ulp is ~4e-3), as tests/test_kernels.py allows;
* the pool writers move values without arithmetic: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.models import layers as jl
from repro.models import paged as jp
from repro.models.lm import LM as JLM
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.models import layers as tl
from repro_torch.models import paged as tp
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ layers


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(w))),
                               _np(jl.rms_norm(_j(x), _j(w))), **F32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    cj, sj = jl.rope_angles(_j(pos), 16, 1e6)
    ct, st = tl.rope_angles(_t(pos), 16, 1e6)
    np.testing.assert_allclose(_np(ct), _np(cj), **F32)
    np.testing.assert_allclose(_np(st), _np(sj), **F32)
    yj = jl.apply_rope(_j(x), cj[..., :, None, :], sj[..., :, None, :])
    yt = tl.apply_rope(_t(x), ct[..., :, None, :], st[..., :, None, :])
    np.testing.assert_allclose(_np(yt), _np(yj), **F32)


@pytest.mark.parametrize("Tq,Tk,q_offset,with_len", [
    (12, 12, 0, False),     # causal prefill, one padded block
    (5, 20, 15, True),      # queries at an offset over a longer context
    (40, 40, 0, True),      # several blocks
])
def test_blockwise_attention_matches(Tq, Tk, q_offset, with_len):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, Tq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, Tk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, Tk, 2, 16)).astype(np.float32)
    kv_len = np.array([Tk, Tk - 3], np.int32) if with_len else None
    kw = dict(causal=True, q_offset=q_offset, block=16)
    yj = jl.attention(_j(q), _j(k), _j(v),
                      kv_len=None if kv_len is None else _j(kv_len), **kw)
    yt = tl.attention(_t(q), _t(k), _t(v),
                      kv_len=None if kv_len is None else _t(kv_len), **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), **F32)


def test_qkv_and_swiglu_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(32, h, 8)).astype(np.float32) * 0.2
                  for h in (4, 2, 2))
    bq, bk, bv = (rng.normal(size=(h, 8)).astype(np.float32)
                  for h in (4, 2, 2))
    outs_j = jl.gqa_qkv(*map(_j, (x, wq, wk, wv, bq, bk, bv)))
    outs_t = tl.gqa_qkv(*map(_t, (x, wq, wk, wv, bq, bk, bv)))
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        _np(tl.swiglu(*map(_t, (x, wg, wu, wd)))),
        _np(jl.swiglu(*map(_j, (x, wg, wu, wd)))), **F32)


# ------------------------------------------------------------------ paged


@pytest.mark.parametrize("wpage", [[0, -1, 5], [-1, -1, -1], [3, 3, 7]])
def test_write_kv_drops_holes_like_reference(wpage):
    """A hole row is dropped — never clamped onto page 0, a live page
    (rows 0 and 1 of the first case both address page 0, slot 0)."""
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(8, 4, 2, 16)).astype(np.float32)
    new = rng.normal(size=(3, 2, 16)).astype(np.float32)
    wpage = np.asarray(wpage, np.int32)
    wslot = np.array([0, 0, 3], np.int32)
    kj, vj = jp.write_kv(_j(pool), _j(pool), _j(new), _j(new * 2),
                         _j(wpage), _j(wslot))
    kt, vt = _t(pool).clone(), _t(pool).clone()
    out = tp.write_kv(kt, vt, _t(new), _t(new * 2), _t(wpage), _t(wslot))
    assert out[0] is kt and out[1] is vt                 # in place
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(vt), _np(vj))


@pytest.mark.parametrize("tok_offset", [0, 8])
def test_write_prefill_kv_matches_reference(tok_offset):
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(16, 8, 2, 16)).astype(np.float32)
    seq = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    tables = np.array([[3, -1, 9, 0, -1], [-1, 5, 6, -1, 12]], np.int32)
    kw = dict(frame_pages=4, tok_offset=tok_offset)
    kj, _ = jp.write_prefill_kv(_j(pool), _j(pool), _j(seq), _j(seq),
                                _j(tables), **kw)
    kt = _t(pool).clone()
    tp.write_prefill_kv(kt, kt.clone(), _t(seq), _t(seq), _t(tables), **kw)
    np.testing.assert_array_equal(_np(kt), _np(kj))


# ------------------------------------------------------------------ LM


GEO_KW = dict(page_tokens=8, frame_pages=4)


def _bridged(dtype):
    """Both packages' LMs on the reference's weights (random biases)."""
    jcfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype=dtype)
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for b in ("bq", "bk", "bv"):
        a = params["decoder"]["attn"][b]
        params["decoder"]["attn"][b] = (rng.normal(size=a.shape) * 0.1
                                        ).astype(np.float32)
    tlm = TLM(tcfg)
    tlm.load_state_dict(params_from_jax(params))
    return jcfg, JLM(jcfg), jax.tree.map(jnp.asarray, params), tlm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_match_reference(dtype):
    tol = F32 if dtype == "float32" else BF16
    jcfg, jlm, jparams, tlm = _bridged(dtype)
    pool_j = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pool_t = torch.float32 if dtype == "float32" else torch.bfloat16
    NP, mpps, ptok = 32, 12, 8
    (kshape, _), _ = tlm.pool_shapes(NP, ptok)
    assert kshape == jlm.pool_shapes(NP, ptok)[0].shape
    pools_j = (jnp.zeros(kshape, pool_j), jnp.zeros(kshape, pool_j))
    pools_t = (torch.zeros(kshape, dtype=pool_t),
               torch.zeros(kshape, dtype=pool_t))
    jc, tc = JCache(JGeo(**GEO_KW), NP, 1), TCache(TGeo(**GEO_KW), NP, 1)
    rng = np.random.default_rng(6)
    nxt = []
    for rid, T in ((0, 13), (1, 21)):
        jc.allocate(rid, T)
        tc.allocate(rid, T)
        Tpad = -(-T // ptok) * ptok
        toks = np.zeros((1, Tpad), np.int32)
        toks[0, :T] = rng.integers(0, jcfg.vocab_size, T)
        lj, pools_j, _ = jlm.prefill(
            jparams, {"tokens": _j(toks)}, pools_j, jc.pack_ctx([rid], mpps),
            last_pos=_j(np.array([T - 1], np.int32)))
        lt, _ = tlm.prefill({"tokens": _t(toks)}, pools_t,
                            tc.pack_ctx([rid], mpps),
                            last_pos=_t(np.array([T - 1], np.int32)))
        np.testing.assert_allclose(_np(lt), _np(lj), **tol)
        nxt.append(int(np.argmax(_np(lj)[0])))
    for _ in range(3):
        for rid in (0, 1):
            jc.append(rid)
            tc.append(rid)
        pos = np.array([jc.seq_tokens[0] - 1, jc.seq_tokens[1] - 1], np.int32)
        toks = np.asarray(nxt, np.int32)
        lj, pools_j, _ = jlm.decode_step(jparams, _j(toks), _j(pos), pools_j,
                                         jc.pack_ctx([0, 1], mpps))
        lt, _ = tlm.decode_step(_t(toks), _t(pos), pools_t,
                                tc.pack_ctx([0, 1], mpps))
        np.testing.assert_allclose(_np(lt), _np(lj), **tol)
        nxt = list(np.argmax(_np(lj), axis=-1))
    for pj, pt in zip(pools_j, pools_t):
        np.testing.assert_allclose(_np(pt), _np(pj), **tol)


def test_lm_refuses_unported_families():
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), family="ssm")
    with pytest.raises(NotImplementedError, match="later slice"):
        TLM(cfg)


def test_port_init_draws_reference_distributions():
    """The port's own init (torch.Generator) follows the reference's
    distributions: truncated-normal fan-in weights, N(0, 0.02) embeddings,
    unit norms, zero biases."""
    cfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32",
                              d_model=128, d_ff=256)
    lm = TLM(cfg).init_weights(torch.Generator().manual_seed(0))
    wq = lm.decoder.attn.wq
    assert wq.abs().max() <= 3 / 128 ** 0.5 + 1e-6
    assert abs(float(wq.std()) * 128 ** 0.5 - 0.987) < 0.05  # N(0,1) cut at ±3
    assert abs(float(lm.embed.std()) - 0.02) < 0.002
    assert torch.equal(lm.final_norm, torch.ones(128))
    assert not lm.decoder.attn.bq.any()
