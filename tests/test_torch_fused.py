"""Fused gather-attend decode in the port vs the reference, on the CPU.

The port's kernel wrapper runs its plain version here
(:func:`repro_torch.kernels.ref.fused_paged_attention_ref`, one accumulator
in table order).  It is held against the reference's plain
``paged_attention_local(..., slots=...)`` (the same order), against the
Pallas ``fused_paged_attention_kernel`` in interpret mode and its eager
mirror ``fused_gather_attend_ref`` (two accumulators, ready and late,
combined at the end: another summation order), and bitwise against the
port's own slot-free path where the bytes read are the same.  Inputs are
drawn with numpy from a seed.

Tolerance: float32, rtol/atol 2e-5 (tests/test_kernels.py's f32 bound:
the same math summed in another order or another framework).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import PoolGeometry as JGeo
from repro.kernels.paged_attention import \
    fused_paged_attention_kernel as pallas_fused
from repro.kernels.ref import fused_gather_attend_ref
from repro.models import paged as jp
from repro.models.lm import LM as JLM
from repro.models.transformer import PageCtx as JCtx
from repro.serving.kv_cache import ShardedKVCache as JCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import PoolGeometry as TGeo
from repro_torch.kernels import ops, ref
from repro_torch.models.lm import LM as TLM
from repro_torch.models.transformer import PageCtx as TCtx
from repro_torch.serving.kv_cache import ShardedKVCache as TCache

TOL = dict(rtol=2e-5, atol=2e-5)
CASES = ["all_ready", "partial", "all_staged", "zero_resident_row",
         "holes", "empty_stage"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain versions run on tiny tensors here: one intra-op
    thread keeps them from spinning against the other test workers'
    threads (a parallel run is otherwise many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(kind, seed=0, *, garbage=True):
    """q, pools, stage, tables, slots, ntok (numpy f32/int32) for one case.

    Staged pages carry the pool page's true bytes; with ``garbage`` the
    pool copy of every staged page is overwritten, so reading the wrong
    source shows."""
    rng = np.random.default_rng(seed)
    B, nblk, n_kv, g, dh, ptok = 3, 5, 2, 2, 16, 8
    NP = B * nblk + 3
    q = rng.standard_normal((B, n_kv * g, dh), np.float32)
    pk = rng.standard_normal((NP, ptok, n_kv, dh), np.float32)
    pv = rng.standard_normal((NP, ptok, n_kv, dh), np.float32)
    tables = rng.permutation(NP)[:B * nblk].reshape(B, nblk).astype(np.int32)
    ntok = rng.integers(1, ptok + 1, (B, nblk)).astype(np.int32)
    late = np.zeros((B, nblk), bool)
    if kind in ("partial", "holes"):
        late[:, 1::2] = True
        late[0, 0] = True                   # first block late on row 0
    elif kind == "all_staged":
        late[:] = True
    elif kind == "zero_resident_row":
        late[0, :] = True                   # nothing of row 0 is resident
        late[2, -1] = True                  # a single straggler on row 2
    if kind == "holes":
        for b, blk in ((1, 2), (1, 3), (2, 0)):
            tables[b, blk], ntok[b, blk] = -1, 0
    late &= tables >= 0
    sk, sv = pk[tables[late]], pv[tables[late]]
    if garbage:
        pk, pv = pk.copy(), pv.copy()
        pk[tables[late]] = rng.standard_normal(sk.shape).astype(np.float32)
        pv[tables[late]] = rng.standard_normal(sv.shape).astype(np.float32)
    slots = np.full((B, nblk), -1, np.int32)
    slots[late] = np.arange(int(late.sum()), dtype=np.int32)
    return q, pk, pv, sk, sv, tables, slots, ntok, dh ** -0.5


def _port(q, pk, pv, sk, sv, tables, slots, ntok, scale):
    t = torch.from_numpy
    return ops.fused_paged_attention_kernel(
        t(q), t(pk), t(pv), t(sk), t(sv), t(tables), t(slots), t(ntok),
        scale=scale)


def _jax_stage(pk, sk, sv):
    """The reference's kernel needs a non-empty stage (it pads NS = 0 with
    a dummy page itself; its plain path indexes the stage unguarded)."""
    if sk.shape[0]:
        return jnp.asarray(sk), jnp.asarray(sv)
    dummy = np.zeros((1, *pk.shape[1:]), np.float32)
    return jnp.asarray(dummy), jnp.asarray(dummy)


def _close(port, other):
    for a, b in zip(port, other):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kind", CASES)
def test_fused_plain_matches_reference_local(kind):
    """(a) The port's plain version vs the reference's
    ``paged_attention_local(..., slots=...)``."""
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _case(kind, seed=1)
    assert (sk.shape[0] == 0) == (kind in ("all_ready", "empty_stage"))
    jsk, jsv = _jax_stage(pk, sk, sv)
    want = jp.paged_attention_local(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(ntok), scale=scale, stage_k=jsk, stage_v=jsv,
        slots=jnp.asarray(slots))
    _close(_port(q, pk, pv, sk, sv, tables, slots, ntok, scale), want)


@pytest.mark.parametrize("kind", CASES)
def test_fused_plain_matches_pallas_and_eager_mirror(kind):
    """(b) The same inputs vs the Pallas kernel in interpret mode and vs
    ``fused_gather_attend_ref`` (two accumulators: another sum order)."""
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _case(kind, seed=2)
    port = _port(q, pk, pv, sk, sv, tables, slots, ntok, scale)
    jsk, jsv = _jax_stage(pk, sk, sv)
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jsk, jsv,
            jnp.asarray(tables), jnp.asarray(slots), jnp.asarray(ntok))
    _close(port, pallas_fused(*args, scale=scale, interpret=True))
    _close(port, fused_gather_attend_ref(*args, scale=scale))


@pytest.mark.parametrize("kind", ["partial", "all_staged",
                                  "zero_resident_row", "holes"])
def test_fused_plain_bitwise_inside_port(kind):
    """(c) One accumulator in table order: every slot -1 gives the page
    path's plain version bitwise, and staged bytes equal to the pool's
    give the slot-free call bitwise."""
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _case(
        kind, seed=3, garbage=False)
    t = torch.from_numpy
    base = ref.paged_attention_ref(t(q), t(pk), t(pv), t(tables), t(ntok),
                                   scale=scale)
    staged = _port(q, pk, pv, sk, sv, tables, slots, ntok, scale)
    ready = _port(q, pk, pv, sk, sv, tables, np.full_like(slots, -1), ntok,
                  scale)
    via_kernel_wrapper = ops.paged_attention_kernel(
        t(q), t(pk), t(pv), t(tables), t(ntok), granularity="page",
        scale=scale)
    for a, b, c, d in zip(staged, ready, base, via_kernel_wrapper):
        assert torch.equal(a, c) and torch.equal(b, c) and torch.equal(d, c)


def test_fused_wrapper_counts_no_launch_on_cpu():
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _case("partial")
    ops.reset_launch_counts()
    _port(q, pk, pv, sk, sv, tables, slots, ntok, scale)
    assert ops.launch_counts()["paged_attention.fused"] == 0
    assert "paged_attention.fused" in ops.KERNELS


# ------------------------------------------------------------- model level


GEO_KW = dict(page_tokens=8, frame_pages=4, headroom=1.25,
              compact_threshold=0.4)


def test_lm_decode_with_staged_pages_matches_reference():
    """(d) A PageCtx carrying slots and layer-stacked stages through
    ``LM.decode_step``: logits allclose to the reference's with the same
    PageCtx fields, and equal to the port's own all-resident decode."""
    jcfg = dataclasses.replace(j_smoke("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2.5-3b"), dtype="float32")
    params = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(0)))
    jlm, tlm = JLM(jcfg), TLM(tcfg)
    tlm.load_state_dict(params_from_jax(params))
    jparams = jax.tree.map(jnp.asarray, params)
    NP, mpps, ptok = 32, 12, 8
    (kshape, _), _ = tlm.pool_shapes(NP, ptok)
    pools_j = (jnp.zeros(kshape, jnp.float32), jnp.zeros(kshape, jnp.float32))
    pools_t = (torch.zeros(kshape), torch.zeros(kshape))
    jc, tc = JCache(JGeo(**GEO_KW), NP, 1), TCache(TGeo(**GEO_KW), NP, 1)
    rng = np.random.default_rng(7)
    nxt = []
    for rid, T in ((0, 21), (1, 30)):
        jc.allocate(rid, T)
        tc.allocate(rid, T)
        toks = np.zeros((1, -(-T // ptok) * ptok), np.int32)
        toks[0, :T] = rng.integers(0, jcfg.vocab_size, T)
        last = np.array([T - 1], np.int32)
        lj, pools_j, _ = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     pools_j, jc.pack_ctx([rid], mpps),
                                     last_pos=jnp.asarray(last))
        tlm.prefill({"tokens": torch.from_numpy(toks)}, pools_t,
                    tc.pack_ctx([rid], mpps), last_pos=torch.from_numpy(last))
        nxt.append(int(np.argmax(np.asarray(lj)[0])))
    for rid in (0, 1):
        jc.append(rid)
        tc.append(rid)
    jctx, tctx = jc.pack_ctx([0, 1], mpps), tc.pack_ctx([0, 1], mpps)
    tables = tctx.tables.numpy()
    wpages = set(tctx.wpage.numpy().ravel().tolist())
    # Stage every other non-write page with its true bytes, then overwrite
    # the pool's copy: decode must read the stage.
    staged = [p for p in tables.ravel().tolist()
              if p >= 0 and p not in wpages][::2]
    assert len(staged) >= 3
    slots = np.full(tables.shape, -1, np.int32)
    for i, p in enumerate(staged):
        slots[tables == p] = i
    kp, vp = (x[:, staged].clone() for x in pools_t)       # [L, NS, ...]
    clean_t = tuple(x.clone() for x in pools_t)
    for x in pools_t:
        x[:, staged] = torch.from_numpy(
            rng.standard_normal(x[:, staged].shape).astype(np.float32))
    pools_j = tuple(jnp.asarray(x.numpy()) for x in pools_t)
    toks = np.asarray(nxt, np.int32)
    pos = np.array([jc.seq_tokens[0] - 1, jc.seq_tokens[1] - 1], np.int32)
    jctx = dataclasses.replace(jctx, slots=jnp.asarray(slots),
                               stage_k=jnp.asarray(kp.numpy()),
                               stage_v=jnp.asarray(vp.numpy()))
    tctx_f = dataclasses.replace(tctx, slots=torch.from_numpy(slots),
                                 stage_k=kp, stage_v=vp)
    assert isinstance(jctx, JCtx) and isinstance(tctx_f, TCtx)
    lj, _, _ = jlm.decode_step(jparams, jnp.asarray(toks), jnp.asarray(pos),
                               pools_j, jctx)
    lt, _ = tlm.decode_step(torch.from_numpy(toks), torch.from_numpy(pos),
                            pools_t, tctx_f)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               rtol=1e-4, atol=1e-4)
    # The staged bytes are the pool's true bytes: the port's all-resident
    # decode on the clean pools gives the same logits bitwise.
    lt_clean, _ = tlm.decode_step(torch.from_numpy(toks),
                                  torch.from_numpy(pos), clean_t, tctx)
    assert torch.equal(lt, lt_clean)
