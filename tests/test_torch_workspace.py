"""The card's transient workspace: the page ring and in-place prefill.

* ``PageRing`` (``serving/page_ring.py``): chunked gathers and landings
  give the whole-batch path's payloads and pool bytes byte for byte, at
  chunks of 1, 3, a frame and more pages than the transfer holds, for
  dense pools and for MLA's latent pools of unequal K and V widths.
* The engine: tokens and modeled paging counters are the same with the
  frame-sized ring and with a 1-page one, in sync and async; ``xfer_chunks``
  counts the chunks moved, in ``EngineStats`` and in the step log.
* Dense prefill's row blocks written in place: logits and pools bitwise
  equal to the list-and-cat path it replaced (kept below), suffix prefill
  bitwise equal to full prefill across row blocks, and ``swiglu`` still
  differentiable.

Imports no JAX; the port runs its kernels' plain versions (CPU tensors).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PoolGeometry
from repro_torch.kernels import ref
from repro_torch.models import lm as lm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import out_proj, rms_norm, swiglu
from repro_torch.models.lm import LM
from repro_torch.models.page_ops import PageCtx, prefill_write_op
from repro_torch.serving import spans
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.page_ring import PageRing

FRAME = 4
GEO = dict(page_tokens=8, frame_pages=FRAME, compact_threshold=0.4)
MODELED = ("faults", "fault_dmas", "fault_steps", "bytes_in", "transfer_us",
           "fault_exposed_us", "fault_hidden_us", "prefetch_hits",
           "prefetch_misses", "prefetch_wasted", "evict_pages", "evict_dmas",
           "bytes_out", "evict_us", "swaps_out", "swaps_in",
           "compaction_copies", "prefix_hits", "prefix_parked_pages",
           "h2d_bytes", "d2h_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- page ring

POOLS = {
    # [L, NP, ptok, n_kv, dh] K and V
    "dense": ((3, 40, 8, 2, 16), (3, 40, 8, 2, 16)),
    # MLA's latent pools: one KV head, K wider than V
    "mla": ((3, 40, 8, 1, 24), (3, 40, 8, 1, 16)),
}
N_PAGES = 11


def _pools(kind, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(torch.bfloat16)
                 for shape in POOLS[kind])


@pytest.mark.parametrize("kind", sorted(POOLS))
@pytest.mark.parametrize("chunk", [1, 3, FRAME, N_PAGES + 5])
def test_ring_gather_matches_whole_batch(kind, chunk):
    pools = _pools(kind, 0)
    idx = torch.randperm(40, generator=torch.Generator().manual_seed(1))[
        :N_PAGES].to(torch.int32)
    (kp, vp), chunks = PageRing(pools, chunk).gather(idx)
    assert chunks == -(-N_PAGES // chunk)
    for got, pool in zip((kp, vp), pools):
        want = ref.page_gather_ref(pool, idx)
        assert got.dtype == pool.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("kind", sorted(POOLS))
@pytest.mark.parametrize("chunk", [1, 3, FRAME, N_PAGES + 5])
def test_ring_scatter_matches_whole_batch(kind, chunk):
    pools = _pools(kind, 2)
    src = _pools(kind, 3)
    idx = torch.randperm(40, generator=torch.Generator().manual_seed(4))[
        :N_PAGES].to(torch.int32)
    # Per-page payloads as the host store holds them: views of a gather.
    gathered = [ref.page_gather_ref(p, idx) for p in src]
    payloads = [tuple(g[:, i] for g in gathered) for i in range(N_PAGES)]
    whole = tuple(p.clone() for p in pools)
    for pool, g in zip(whole, gathered):
        ref.page_scatter_ref(pool, idx, g)
    ring_pools = tuple(p.clone() for p in pools)
    landed = []

    def land(ix, kp, vp):
        landed.append(ix.shape[0])
        ref.page_scatter_ref(ring_pools[0], ix, kp)
        ref.page_scatter_ref(ring_pools[1], ix, vp)

    chunks = PageRing(ring_pools, chunk).scatter(idx, payloads, land)
    assert chunks == len(landed) == -(-N_PAGES // chunk)
    assert max(landed) <= chunk and sum(landed) == N_PAGES
    for got, want in zip(ring_pools, whole):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_ring_refuses_an_empty_chunk():
    with pytest.raises(ValueError):
        PageRing(_pools("dense", 0), 0)


# ---------------------------------------------------------------- engine


def _serve(mode, chunk=None):
    """The oversubscribed f32 smoke stream of tests/test_torch_spans.py;
    ``chunk`` rebuilds the engine's ring at that many pages a chunk."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    eng = ServingEngine(cfg, geometry=PoolGeometry(**GEO), max_batch=6,
                        max_seq=96, oversubscription=2.0, fault_mode=mode,
                        decode_window_us=1000.0, device="cpu")
    if chunk is not None:
        eng._ring = PageRing(eng.pools, chunk)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    reqs = []
    for i in range(10):
        T = int(rng.integers(24, 56))
        prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
        if i % 2:
            prompt[:16] = shared
        reqs.append(Request(rid=i, tenant=i % 3, prompt=prompt,
                            max_new=int(rng.integers(24, 40)),
                            priority=i % 3))
        eng.submit(reqs[-1])
    eng.run_until_drained(max_steps=2000)
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_engine_tokens_and_counters_with_a_one_page_chunk(mode, monkeypatch):
    log = spans._log.__class__(maxlen=spans.LOG_STEPS)
    monkeypatch.setattr(spans, "_log", log)
    frame, toks = _serve(mode)
    n_frame = len(log)
    one, toks_one = _serve(mode, chunk=1)
    assert toks_one == toks
    a, b = frame.stats, one.stats
    assert {k: getattr(a, k) for k in MODELED} \
        == {k: getattr(b, k) for k in MODELED}
    assert a.swaps_out >= 1 and a.faults >= 1
    # A 1-page chunk moves every page alone; a frame chunk up to FRAME.
    pages = (a.d2h_bytes + a.h2d_bytes) // frame.page_bytes
    assert b.xfer_chunks == pages
    assert pages / FRAME <= a.xfer_chunks < pages
    # Every gather and every landing of these modes goes through the ring.
    for s in (a, b):
        assert s.xfer_chunks == s.gathers + s.landings
    # The step log carries the same count.
    counted = [sum(r["counters"].get("xfer_chunks", 0) for r in part)
               for part in (list(log)[:n_frame], list(log)[n_frame:])]
    assert counted == [a.xfer_chunks, b.xfer_chunks]


# --------------------------------------------------------------- prefill


def _swiglu_out_of_place(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def _row_blocks_cat(fn, *xs):
    """The list-and-cat row blocks that in-place prefill replaced."""
    T = xs[0].shape[1]
    pad = (-T) % tf.PREFILL_ROWS
    if pad:
        xs = [torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))],
                        dim=1) for x in xs]
    outs = [fn(*(x[:, i:i + tf.PREFILL_ROWS] for x in xs))
            for i in range(0, T + pad, tf.PREFILL_ROWS)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1)[:, :T].contiguous()
                     for parts in zip(*outs))
    return torch.cat(outs, dim=1)[:, :T].contiguous()


def _attn_out_ffn_cat(cfg, lp, x, o):
    x = x + out_proj(o, lp["attn"]["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    m = lp["mlp"]
    return x + _swiglu_out_of_place(h, m["w_gate"], m["w_up"], m["w_down"])


def _stack_prefill_cat(cfg, params, x, positions, pools, ctx,
                       prefix_kv=None, tok_offset=0, par=None):
    """The dense stack's prefill before blocks were written in place."""
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        q, k, v = _row_blocks_cat(functools.partial(tf._attn_in, cfg, lp),
                                  x, positions)
        pkv = None if prefix_kv is None else (prefix_kv[0][l],
                                              prefix_kv[1][l])
        o = tf.prefill_attention(q, k, v, pkv)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx,
                         tok_offset=tok_offset)
        x = _row_blocks_cat(functools.partial(_attn_out_ffn_cat, cfg, lp),
                            x, o)
    return x, pools


PTOK = 16


@pytest.fixture(scope="module")
def bf16_lm():
    cfg = get_smoke_config("qwen2.5-3b")
    assert cfg.dtype == "bfloat16" and cfg.family == "dense"
    return cfg, LM(cfg).init_weights(torch.Generator().manual_seed(0))


def _ctx(B, total):
    pages = -(-total // PTOK)
    tables = torch.full((B, 1, pages), -1, dtype=torch.int32)
    ntok = torch.zeros((B, 1, pages), dtype=torch.int32)
    for b in range(B):
        for i in range(pages):
            tables[b, 0, i] = b * pages + i
            ntok[b, 0, i] = min(PTOK, total - i * PTOK)
    return PageCtx(tables=tables, ntok=ntok,
                   wpage=torch.full((B, 1), (total - 1) // PTOK,
                                    dtype=torch.int32),
                   wslot=torch.full((B,), (total - 1) % PTOK,
                                    dtype=torch.int32),
                   frame_pages=FRAME)


def _prefill(lm, prompts, P=0, prefix=None, pools=None):
    """Prefill of [B, T] prompts (tokens from P on; ``prefix`` the cached
    K/V of the first P) into fresh pools; returns (logits, pools)."""
    B, T = prompts.shape
    Tpad = -(-T // PTOK) * PTOK
    if pools is None:
        (shape, dtype), _ = lm.pool_shapes(B * (Tpad // PTOK), PTOK)
        pools = (torch.zeros(shape, dtype=dtype),
                 torch.zeros(shape, dtype=dtype))
    toks = torch.zeros((B, Tpad - P), dtype=torch.int32)
    toks[:, :T - P] = torch.from_numpy(prompts[:, P:])
    kw = {} if prefix is None else dict(prefix_kv=prefix, prefix_len=P)
    logits, pools, _ = lm.prefill({"tokens": toks}, pools, _ctx(B, T),
                                  last_pos=torch.full((B,), T - 1 - P), **kw)
    return logits, pools


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("B,T", [(1, 1), (1, 511), (1, 512), (1, 513),
                                 (1, 1100), (2, 513)])
def test_prefill_bitwise_matches_list_and_cat(bf16_lm, B, T, monkeypatch):
    cfg, lm = bf16_lm
    prompts = np.random.default_rng(T).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    logits, pools = _prefill(lm, prompts)
    monkeypatch.setattr(lm_mod, "decoder_stack_prefill", _stack_prefill_cat)
    logits_cat, pools_cat = _prefill(lm, prompts)
    assert torch.equal(_bits(logits), _bits(logits_cat))
    for a, b in zip(pools, pools_cat):
        assert torch.equal(_bits(a), _bits(b))


def test_suffix_prefill_across_row_blocks_bitwise(bf16_lm):
    """A 33-page cached prefix, a suffix spanning two row blocks."""
    cfg, lm = bf16_lm
    P, T = 33 * PTOK, 1100
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, T)).astype(np.int32)
    logits_full, pools_full = _prefill(lm, prompt)
    L = pools_full[0].shape[0]
    n_pre = P // PTOK
    prefix = tuple(p[:, :n_pre].reshape(L, 1, P, *p.shape[3:])
                   for p in pools_full)
    warm = tuple(torch.zeros_like(p) for p in pools_full)
    for w, p in zip(warm, pools_full):
        w[:, :n_pre] = p[:, :n_pre]
    logits_sfx, pools_sfx = _prefill(lm, prompt, P, prefix, warm)
    assert torch.equal(_bits(logits_sfx), _bits(logits_full))
    for a, b in zip(pools_sfx, pools_full):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swiglu_in_place_without_grad_and_differentiable_with(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, 16, generator=g).to(dtype)
    ws = [torch.randn(16, 24, generator=g).to(dtype),
          torch.randn(16, 24, generator=g).to(dtype),
          torch.randn(24, 16, generator=g).to(dtype)]
    with torch.no_grad():
        y = swiglu(x, *ws)
    want = _swiglu_out_of_place(x, *ws)
    assert torch.equal(_bits(y), _bits(want))
    xg = x.clone().requires_grad_()
    wg = [w.clone().requires_grad_() for w in ws]
    yg = swiglu(xg, *wg)
    assert torch.equal(_bits(yg.detach()), _bits(want))
    yg.float().square().sum().backward()
    xr = x.clone().requires_grad_()
    wr = [w.clone().requires_grad_() for w in ws]
    _swiglu_out_of_place(xr, *wr).float().square().sum().backward()
    for a, b in zip([xg, *wg], [xr, *wr]):
        assert a.grad is not None and torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------- on the card

# qwen2.5-3b: 36 layers, 64-token pages of 2 KV heads of 128, 16-page frames
QWEN_POOL = (36, 64, 2, 128)
QWEN_FRAME = 16
# The longest prompt of the benchmark's mix, padded to its 64-token pages.
LONG_PROMPT = 7936
# Upper end of the predicted transient workspace of that prompt's dense
# prefill (embedding output, residual, q / k / v, attention output and one
# row block's temporaries): bytes over what the card held before it.
PREFILL_WORKSPACE = 135 * 10 ** 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a)")
    return torch.device("cuda")


def _excess(dev, fn):
    """(fn's result, its peak allocated bytes over those before it)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base


@pytest.mark.cuda
def test_ring_stages_at_most_two_chunks_on_the_card(cuda_device):
    """A 123-page gather (the longest prompt's park) and a 102-page
    fault-in at qwen2.5-3b's page shape: the whole-batch path's bytes,
    the card's peak raised by at most two chunks."""
    from repro_torch.kernels import ops
    dev, NP = cuda_device, 140
    g = torch.Generator(device=dev).manual_seed(0)
    L, *page = QWEN_POOL
    pools = tuple(torch.randn((L, NP, *page), generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
    ring = PageRing(pools, QWEN_FRAME)
    two = 2 * QWEN_FRAME * sum(p[:, 0].numel() * p.element_size()
                               for p in pools)
    perm = torch.randperm(NP, generator=torch.Generator().manual_seed(1))
    idx = perm[:123].to(device=dev, dtype=torch.int32)
    ((kp, vp), chunks), excess = _excess(dev, lambda: ring.gather(idx))
    assert chunks == 8 and excess <= two, (chunks, excess, two)
    for got, pool in zip((kp, vp), pools):
        assert torch.equal(got.view(torch.int16),
                           ops.page_gather(pool, idx).cpu().view(torch.int16))
    dst = perm[-102:].to(device=dev, dtype=torch.int32)
    payloads = [(kp[:, i], vp[:, i]) for i in range(102)]
    want = tuple(p.clone() for p in pools)
    for pool, host in zip(want, (kp, vp)):
        ops.page_scatter(pool, dst, host[:, :102].contiguous().to(dev))

    def land(ix, k, v):
        ops.page_scatter(pools[0], ix, k)
        ops.page_scatter(pools[1], ix, v)

    chunks, excess = _excess(dev, lambda: ring.scatter(dst, payloads, land))
    assert chunks == 7 and excess <= two, (chunks, excess, two)
    for got, w in zip(pools, want):
        assert torch.equal(got.view(torch.int16), w.view(torch.int16))


@pytest.mark.cuda
def test_long_prefill_workspace_and_bits_on_the_card(cuda_device,
                                                     monkeypatch):
    """qwen2.5-3b at full width cut to 2 layers, the 7,936-token prompt:
    the in-place row blocks stay under the predicted workspace, below the
    list-and-cat path's, with its logits and pool bytes bit for bit."""
    from repro_torch.configs import get_config
    dev = cuda_device
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    lm = LM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))
    ptok = QWEN_POOL[1]

    def prefill(T):
        """(logits, pools, workspace) of a T-token prompt's prefill."""
        n = T // ptok
        toks = torch.from_numpy(np.random.default_rng(T).integers(
            0, cfg.vocab_size, (1, T)).astype(np.int32)).to(dev)
        tables = torch.arange(n, dtype=torch.int32, device=dev).view(1, 1, n)
        ctx = PageCtx(tables=tables, ntok=torch.full_like(tables, ptok),
                      wpage=torch.full((1, 1), n - 1, dtype=torch.int32,
                                       device=dev),
                      wslot=torch.full((1,), ptok - 1, dtype=torch.int32,
                                       device=dev),
                      frame_pages=QWEN_FRAME)
        pools = tuple(torch.zeros(shape, dtype=dtype, device=dev)
                      for shape, dtype in lm.pool_shapes(n, ptok))
        (logits, pools, _), ws = _excess(dev, lambda: lm.prefill(
            {"tokens": toks}, pools, ctx))
        return logits, pools, ws

    # A first, short prefill builds the kernels and takes cuBLAS's
    # workspace from the allocator: neither is the long prefill's.
    prefill(ptok)
    runs = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(lm_mod, "decoder_stack_prefill",
                                _stack_prefill_cat)
        runs.append(prefill(LONG_PROMPT))
    (logits, pools, ws), (logits_cat, pools_cat, ws_cat) = runs
    print(f"prefill workspace at T={LONG_PROMPT}: in place {ws} B, "
          f"list-and-cat {ws_cat} B")
    assert ws <= PREFILL_WORKSPACE and ws < ws_cat, (ws, ws_cat)
    assert torch.equal(_bits(logits), _bits(logits_cat))
    for a, b in zip(pools, pools_cat):
        assert torch.equal(_bits(a), _bits(b))
