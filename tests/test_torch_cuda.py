"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where only PyTorch is installed
(``--noconftest`` keeps pytest from loading tests/conftest.py, which
imports JAX and the reference package).  Every test here is marked
``cuda`` and skips without a CUDA device; on one, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: normalized attention (decode and prefill) 2e-2 for bf16 and
2e-5 for f32 inputs, as tests/test_kernels.py (other summation order and
rounding points); the f32 accumulators m and l 1e-5; the SSD scan 3e-2
for bf16 and 2e-4 for f32 inputs, as tests/test_kernels.py; its backward
2e-2 (bf16) and 2e-5 (f32) of each gradient's scale; copies exact.
The fused gather-attend kernel is also held bitwise to the page kernel
where it reads the same bytes, the flash kernel's suffix rows bitwise to
its full rows, and the SSD scan bitwise to itself: grouped B / C against
the head-expanded call, two calls, a batch row alone against the batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _block_tables(rng, B, n_blocks, n_entries, tokens_per_block):
    """Tables with holes (-1, ntok 0) and a partial last block per row."""
    tables = np.full((B, n_blocks), -1, np.int32)
    ntok = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        used = int(rng.integers(1, n_blocks + 1))
        slots = np.sort(rng.permutation(n_blocks)[:used])
        ids = rng.permutation(n_entries)[:used]
        for j, (slot, e) in enumerate(zip(slots, ids)):
            tables[b, slot] = e
            ntok[b, slot] = tokens_per_block if j < used - 1 else int(
                rng.integers(1, tokens_per_block + 1))
    return tables, ntok



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", [
    (16, 2, 128),     # qwen2.5-3b
    (4, 4, 32),       # MHA, smallest head dim
    (32, 2, 64),      # 16 query heads per KV head: 4 per warp
    (8, 1, 256),      # largest head dim: > 48 KB of shared memory
    (48, 8, 128),     # dbrx-132b: 6 query heads per KV head
    (32, 8, 128),     # llama3-8b, qwen3-8b, llava-next: g = 4
    (32, 32, 96),     # phi3-mini-3.8b: g = 1 at head dim 96
])
@pytest.mark.parametrize("granularity", ["page", "frame"])
def test_cuda_paged_attention_matches_plain(cuda_device, granularity, H,
                                            n_kv, dh, dtype):
    rng = np.random.default_rng(12)
    B, ptok, fp = 4, 64, 16
    NP = 5 * fp
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pk, pv = (torch.randn((NP, ptok, n_kv, dh), generator=gen,
                          device=cuda_device).to(tdt) for _ in range(2))
    q = torch.randn((B, H, dh), generator=gen, device=cuda_device).to(tdt)
    if granularity == "page":
        tables, ntok = _block_tables(rng, B, 32, NP, ptok)
    else:
        tables, ntok = _block_tables(rng, B, 2, NP // fp, fp * ptok)
    tables[-1], ntok[-1] = -1, 0                 # a row made only of holes
    tables, ntok = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, ntok))
    before = ops.launch_counts()[f"paged_attention.{granularity}"]
    o, m, l = ops.paged_attention_kernel(q, pk, pv, tables, ntok,
                                         granularity=granularity,
                                         frame_pages=fp, scale=dh ** -0.5)
    o_r, m_r, l_r = ref.paged_attention_ref(
        q, pk, pv, tables, ntok, scale=dh ** -0.5,
        frame_pages=fp if granularity == "frame" else 1)
    assert ops.launch_counts()[f"paged_attention.{granularity}"] == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o[:-1] / l[:-1, :, None],
                               o_r[:-1] / l_r[:-1, :, None], **tol)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    assert (m[-1] == -1e30).all() and (l[-1] == 0).all() and (o[-1] == 0).all()


# Split-KV layouts: each row is a list of (block, valid tokens) over a table
# of n_blocks blocks of tpb tokens; the kernels walk 128-position splits.
def _split_rows(tpb, n_blocks):
    half = tpb // 2
    return [
        [(i, tpb) for i in range(5)] + [(5, half + 5)],  # several splits,
        # the last one partial
        [(0, tpb), (1, tpb), (4, tpb), (5, tpb), (6, 5)],  # blocks 2, 3
        # holes: whole splits of holes inside the row
        [(0, 1)],                                      # one token
        [(i, tpb) for i in range(n_blocks)],           # the full width
        [(n_blocks // 2 + 1, 3)],                      # leading hole splits
        [],                                            # only holes
    ]


def _split_case(dev, granularity, H, n_kv, dh, dtype, seed=5, dh_v=None):
    """Tables of _split_rows over a pool of 64-token pages (page and fused)
    or 4-page frames of 64-token pages, 256 tokens a frame (frame: splits cut
    inside frames).  Fused stages about half of the valid pages with the
    pool's bytes and overwrites the pool copies.  ``dh_v``: the V pool's
    width (default dh)."""
    rng = np.random.default_rng(seed)
    ptok, fp = 64, (4 if granularity == "frame" else 1)
    tpb, n_blocks = ptok * fp, (8 if granularity == "frame" else 16)
    n_entries = 2 * n_blocks
    NP = n_entries * fp
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, pv = (torch.randn((NP, ptok, n_kv, w), generator=gen,
                          device=dev).to(dtype) for w in (dh, dh_v or dh))
    rows = _split_rows(tpb, n_blocks)
    B = len(rows)
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    tables = np.full((B, n_blocks), -1, np.int32)
    ntok = np.zeros((B, n_blocks), np.int32)
    for b, row in enumerate(rows):
        ids = rng.permutation(n_entries)[:len(row)]
        for (blk, n), e in zip(row, ids):
            tables[b, blk], ntok[b, blk] = e, n
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    case = dict(q=q, pk=pk, pv=pv, tables=t(tables), ntok=t(ntok), fp=fp,
                scale=dh ** -0.5)
    if granularity == "fused":
        late = (tables >= 0) & (rng.random(tables.shape) < 0.5)
        ids = torch.from_numpy(tables[late]).long().to(dev)
        sk, sv = pk[ids].contiguous(), pv[ids].contiguous()
        pk[ids] = torch.randn(sk.shape, generator=gen, device=dev).to(dtype)
        pv[ids] = torch.randn(sv.shape, generator=gen, device=dev).to(dtype)
        slots = np.full(tables.shape, -1, np.int32)
        slots[late] = np.arange(int(late.sum()), dtype=np.int32)
        case.update(sk=sk, sv=sv, slots=t(slots))
    return case


def _run_split_case(c, granularity, *, plain=False):
    if granularity == "fused":
        fn = ref.fused_paged_attention_ref if plain else \
            ops.fused_paged_attention_kernel
        return fn(c["q"], c["pk"], c["pv"], c["sk"], c["sv"], c["tables"],
                  c["slots"], c["ntok"], scale=c["scale"])
    if plain:
        return ref.paged_attention_ref(c["q"], c["pk"], c["pv"],
                                       c["tables"], c["ntok"],
                                       scale=c["scale"], frame_pages=c["fp"])
    return ops.paged_attention_kernel(c["q"], c["pk"], c["pv"], c["tables"],
                                      c["ntok"], granularity=granularity,
                                      frame_pages=c["fp"], scale=c["scale"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", [
    (4, 4, 64),       # g = 1 (zamba2's shared block)
    (8, 4, 128),      # g = 2
    (16, 2, 128),     # g = 8 (qwen2.5-3b)
    (48, 8, 128),     # g = 6 (dbrx-132b)
    (32, 8, 128),     # g = 4 (llama3-8b, qwen3-8b, llava-next)
    (32, 32, 96),     # g = 1 at head dim 96 (phi3-mini-3.8b)
])
@pytest.mark.parametrize("granularity", ["page", "frame", "fused"])
def test_cuda_paged_attention_splits_match_plain(cuda_device, granularity,
                                                 H, n_kv, dh, dtype):
    """Rows over several splits with a partial last one, a split of holes
    inside a row, rows of different lengths, trailing hole splits and a
    row of holes, against the plain version (tolerances as above)."""
    c = _split_case(cuda_device, granularity, H, n_kv, dh,
                    getattr(torch, dtype))
    key = "paged_attention." + granularity
    before = ops.launch_counts()[key]
    o, m, l = _run_split_case(c, granularity)
    o_r, m_r, l_r = _run_split_case(c, granularity, plain=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()[key] == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o[:-1] / l[:-1, :, None],
                               o_r[:-1] / l_r[:-1, :, None], **tol)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    assert (m[-1] == -1e30).all() and (l[-1] == 0).all() and (o[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("granularity", ["page", "frame", "fused"])
def test_cuda_paged_attention_row_is_bitwise_invariant(cuda_device,
                                                       granularity, dtype):
    """A row's (o, m, l) is the same bits alone as in a batch of 6, with its
    bytes at other page ids, and with extra hole columns in the table."""
    c = _split_case(cuda_device, granularity, 16, 2, 128,
                    getattr(torch, dtype))
    _check_rows_bitwise_invariant(cuda_device, c, granularity)


def _check_rows_bitwise_invariant(cuda_device, c, granularity):
    """Every row of case ``c`` alone, at permuted page ids and with five
    extra hole columns gives the full call's bits."""
    full = _run_split_case(c, granularity)
    n_entries = c["tables"].shape[1] * 2
    perm = torch.from_numpy(np.random.default_rng(9).permutation(
        n_entries).astype(np.int32)).to(cuda_device)
    fp = c["fp"]
    moved = dict(c)
    # Entry e moves to perm[e]: its pages (a frame's fp pages) go with it.
    page_of = (perm.long()[:, None] * fp + torch.arange(
        fp, device=cuda_device)).reshape(-1)
    for name in ("pk", "pv"):
        moved[name] = torch.empty_like(c[name])
        moved[name][page_of] = c[name]
    moved["tables"] = torch.where(c["tables"] >= 0,
                                  perm[c["tables"].clamp(min=0).long()], -1)
    wide = dict(c)
    pad = lambda a, v: torch.nn.functional.pad(a, (0, 5), value=v)  # noqa
    wide["tables"], wide["ntok"] = pad(c["tables"], -1), pad(c["ntok"], 0)
    if granularity == "fused":
        wide["slots"] = pad(c["slots"], -1)
    for b in range(c["q"].shape[0]):
        alone = dict(c)
        for name in ("q", "tables", "ntok") + (("slots",) if granularity ==
                                               "fused" else ()):
            alone[name] = c[name][b:b + 1].contiguous()
        for variant in (alone, moved, wide):
            got = _run_split_case(variant, granularity)
            rows = slice(0, 1) if variant is alone else slice(b, b + 1)
            for x, y in zip(got, full):
                assert torch.equal(x[rows], y[b:b + 1]), (b, variant.keys())


@pytest.mark.cuda
def test_cuda_paged_attention_refuses_unported_head_dims(cuda_device):
    pool = torch.zeros((4, 8, 2, 48), dtype=torch.bfloat16,
                       device=cuda_device)
    q = torch.zeros((1, 4, 48), dtype=torch.bfloat16, device=cuda_device)
    tb = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 48"):
        ops.paged_attention_kernel(q, pool, pool, tb, tb, granularity="page")


@pytest.mark.cuda
def test_cuda_page_copies_match_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pool = torch.randn((4, 32, 64, 2, 128), generator=gen,
                       device=cuda_device).bfloat16()
    idx = torch.tensor([3, -1, 30, 7], dtype=torch.int32, device=cuda_device)
    assert torch.equal(ops.page_gather(pool, idx),
                       ref.page_gather_ref(pool, idx))
    pages = torch.randn((4, 4, 64, 2, 128), generator=gen,
                        device=cuda_device).bfloat16()
    a, b = pool.clone(), pool.clone()
    ops.page_scatter(a, idx, pages)
    ref.page_scatter_ref(b, idx, pages)
    assert torch.equal(a, b)
    src = torch.tensor([1, -1, 2], dtype=torch.int32, device=cuda_device)
    dst = torch.tensor([20, 21, -1], dtype=torch.int32, device=cuda_device)
    ops.page_compact(a, src, dst)
    ref.page_compact_ref(b, src, dst)
    assert torch.equal(a, b)


def _copy_pool(dev, L, NP, page_shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((L, NP, *page_shape), generator=gen,
                       device=dev).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("page_shape", [
    (64, 2, 128),     # 32 KiB, qwen2.5-3b's page: one load batch
    (64, 32, 96),     # 393,216 B, phi3-mini-3.8b's page
    (2561, 8),        # 40976 B: 2561 vectors, a ragged second batch
    (5, 3, 8),        # 240 B: 15 vectors, less than one thread each
])
def test_cuda_page_copies_few_and_many_entries_match_plain(cuda_device,
                                                           page_shape):
    """Few entries (3 over 4 layers) and more entries than SMs (200 over 2
    layers), with holes: gather, scatter and compact equal their plain
    versions exactly, and all-hole calls leave the pool as it was."""
    rng = np.random.default_rng(5)
    for L, n in ((4, 3), (2, 200)):
        NP = 2 * n + 8
        pool = _copy_pool(cuda_device, L, NP, page_shape, seed=n)
        perm = rng.permutation(NP).astype(np.int32)
        idx = perm[:n].copy()
        idx[1] = -1
        idx_t = torch.from_numpy(idx).to(cuda_device)
        assert torch.equal(ops.page_gather(pool, idx_t),
                           ref.page_gather_ref(pool, idx_t))
        pages = _copy_pool(cuda_device, L, n, page_shape, seed=n + 1)
        a, b = pool.clone(), pool.clone()
        ops.page_scatter(a, idx_t, pages)
        ref.page_scatter_ref(b, idx_t, pages)
        assert torch.equal(a, b)
        src, dst = perm[:n].copy(), perm[n:2 * n].copy()
        src[0] = -1
        dst[-1] = -1
        src_t, dst_t = (torch.from_numpy(v).to(cuda_device)
                        for v in (src, dst))
        a, b = pool.clone(), pool.clone()
        ops.page_compact(a, src_t, dst_t)
        ref.page_compact_ref(b, src_t, dst_t)
        assert torch.equal(a, b)
        holes = torch.full((n,), -1, dtype=torch.int32, device=cuda_device)
        a = pool.clone()
        ops.page_scatter(a, holes, pages)
        ops.page_compact(a, holes, holes)
        torch.cuda.synchronize()
        assert torch.equal(a, pool)


def _fused_case(dev, H, n_kv, dh, dtype, frac, *, garbage=True, seed=21):
    """Page tables over an 80-page pool (32 pages per row, holes, partial
    last pages, a last row made only of holes) with about ``frac`` of the
    valid pages staged.  Staged pages carry the pool page's bytes; with
    ``garbage`` the pool copies are overwritten, so a wrong source shows."""
    rng = np.random.default_rng(seed)
    B, ptok, NP = 4, 64, 80
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk, pv = (torch.randn((NP, ptok, n_kv, dh), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    tables, ntok = _block_tables(rng, B, 32, NP, ptok)
    tables[-1], ntok[-1] = -1, 0
    late = (tables >= 0) & (rng.random(tables.shape) < frac)
    ids = torch.from_numpy(tables[late]).long().to(dev)
    sk, sv = pk[ids].contiguous(), pv[ids].contiguous()
    if garbage:
        pk[ids] = torch.randn(sk.shape, generator=gen, device=dev).to(dtype)
        pv[ids] = torch.randn(sv.shape, generator=gen, device=dev).to(dtype)
    slots = np.full(tables.shape, -1, np.int32)
    slots[late] = np.arange(int(late.sum()), dtype=np.int32)
    tables, slots, ntok = (torch.from_numpy(a).to(dev)
                           for a in (tables, slots, ntok))
    return q, pk, pv, sk, sv, tables, slots, ntok, dh ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", [
    (16, 2, 128),     # qwen2.5-3b
    (4, 4, 32),       # MHA, smallest head dim
    (32, 2, 64),      # 16 query heads per KV head
    (8, 1, 256),      # largest head dim: > 48 KB of shared memory
])
def test_cuda_fused_paged_attention_matches_plain(cuda_device, H, n_kv, dh,
                                                  dtype, frac):
    args = _fused_case(cuda_device, H, n_kv, dh, getattr(torch, dtype), frac)
    q, pk, pv, sk, sv, tables, slots, ntok, scale = args
    assert (sk.shape[0] == 0) == (frac == 0.0)       # frac 0: NS = 0
    before = ops.launch_counts()["paged_attention.fused"]
    o, m, l = ops.fused_paged_attention_kernel(*args[:-1], scale=scale)
    o_r, m_r, l_r = ref.fused_paged_attention_ref(*args[:-1], scale=scale)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention.fused"] == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o[:-1] / l[:-1, :, None],
                               o_r[:-1] / l_r[:-1, :, None], **tol)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    assert (m[-1] == -1e30).all() and (l[-1] == 0).all() and (o[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_cuda_fused_bitwise_equals_page_kernel(cuda_device, frac, dtype):
    """One accumulator in table order: staged bytes equal to the pool's,
    or every slot -1, give the page kernel's output bit for bit."""
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _fused_case(
        cuda_device, 16, 2, 128, getattr(torch, dtype), frac, garbage=False)
    base = ops.paged_attention_kernel(q, pk, pv, tables, ntok,
                                      granularity="page", scale=scale)
    staged = ops.fused_paged_attention_kernel(q, pk, pv, sk, sv, tables,
                                              slots, ntok, scale=scale)
    ready = ops.fused_paged_attention_kernel(
        q, pk, pv, sk, sv, tables, torch.full_like(slots, -1), ntok,
        scale=scale)
    torch.cuda.synchronize()
    for a, b, c in zip(staged, ready, base):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.cuda
def test_cuda_fused_wrapper_refuses_bad_stages(cuda_device):
    q, pk, pv, sk, sv, tables, slots, ntok, scale = _fused_case(
        cuda_device, 16, 2, 128, torch.bfloat16, 0.5)
    ns = sk.shape[0]
    with pytest.raises(ValueError, match="stage_k on cpu"):
        ops.fused_paged_attention_kernel(q, pk, pv, sk.cpu(), sv, tables,
                                         slots, ntok, scale=scale)
    flat = torch.empty(sk.numel() + 8, dtype=sk.dtype, device=cuda_device)
    odd = flat[1:1 + sk.numel()].view(sk.shape)      # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.fused_paged_attention_kernel(q, pk, pv, odd, sv, tables, slots,
                                         ntok, scale=scale)
    bad = slots.clone()
    bad[0, 0] = ns
    with pytest.raises(ValueError, match="out of range"):
        ops.fused_paged_attention_kernel(q, pk, pv, sk, sv, tables, bad,
                                         ntok, scale=scale)
    with pytest.raises(ValueError, match="out of range"):
        ops.fused_paged_attention_kernel(q, pk, pv, sk[:0], sv[:0], tables,
                                         slots, ntok, scale=scale)


def _flash_case(dev, B, Tq, Tk, H, n_kv, dh, dtype, seed=31):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Tq, H, dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Tk, n_kv, dh), generator=gen,
                        device=dev).to(dtype) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", [
    (16, 2, 128),     # qwen2.5-3b
    (4, 4, 32),       # MHA, smallest head dim
    (32, 2, 64),      # 16 query heads per KV head
    (8, 1, 256),      # largest head dim: > 48 KB of shared memory
    (6, 2, 96),       # 3 query heads per KV head: rows that do not tile
    (48, 8, 128),     # dbrx-132b: 6 query heads per KV head
    (32, 32, 96),     # phi3-mini-3.8b: g = 1 at head dim 96
])
@pytest.mark.parametrize("Tq,Tk,q_offset,with_len,causal", [
    (200, 200, 0, False, True),     # full prefill, lengths off the tiles
    (77, 300, 223, False, True),    # suffix prefill over a cached prefix
    (130, 130, 0, True, False),     # non-causal, rows cut at kv_len
    (50, 181, 131, True, True),     # suffix with kv_len
])
def test_cuda_flash_attention_matches_plain(cuda_device, H, n_kv, dh, dtype,
                                            Tq, Tk, q_offset, with_len,
                                            causal):
    q, k, v = _flash_case(cuda_device, 2, Tq, Tk, H, n_kv, dh,
                          getattr(torch, dtype))
    kv_len = (torch.tensor([Tk, Tk - 37], dtype=torch.int32,
                           device=cuda_device) if with_len else None)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              scale=dh ** -0.5)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_kv", [
    (4, 4), (8, 4), (16, 2),        # g 1, 2, 8
    (48, 8),                        # g 6 (dbrx-132b)
])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("Tq,Tk,q_offset,with_len,causal", [
    (200, 200, 0, False, True),     # full prefill, lengths off the tiles
    (77, 300, 223, False, True),    # suffix prefill over a cached prefix
    (130, 130, 0, True, False),     # non-causal, rows cut at kv_len
    (50, 181, 131, True, True),     # suffix with kv_len
])
def test_cuda_flash_tensor_core_path_matches_plain(cuda_device, H, n_kv, dh,
                                                   Tq, Tk, q_offset,
                                                   with_len, causal):
    """The bf16 tensor-core path at the head dims of zamba2's shared block
    (64) and qwen2.5-3b (128), g in {1, 2, 6, 8}, at the bf16 tolerance."""
    q, k, v = _flash_case(cuda_device, 2, Tq, Tk, H, n_kv, dh,
                          torch.bfloat16, seed=33)
    kv_len = (torch.tensor([Tk - 11, Tk], dtype=torch.int32,
                           device=cuda_device) if with_len else None)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", [
    (16, 16, 64),     # seamless-m4t-large-v2
    (32, 8, 128),     # g = 4
])
@pytest.mark.parametrize("B,Tq,Tk", [
    (1, 300, 300),    # encoder: every row over every key
    (2, 150, 517),    # cross-attention at prefill: Tq < Tk
    (4, 1, 4096),     # cross-attention at decode: one row a sequence
    (2, 200, 64),     # Tq > Tk: a long prompt over a short memory
])
def test_cuda_flash_non_causal_cross_shapes_match_plain(cuda_device, dtype,
                                                        H, n_kv, dh, B, Tq,
                                                        Tk):
    """The non-causal shapes of the encoder and of cross-attention,
    queries and keys of independent lengths, against the plain version."""
    q, k, v = _flash_case(cuda_device, B, Tq, Tk, H, n_kv, dh,
                          getattr(torch, dtype), seed=35)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("P", [64, 576, 100])
def test_cuda_flash_suffix_rows_equal_full_rows_bitwise(cuda_device, dtype,
                                                        P):
    """A suffix call (queries from position P over all keys) gives the
    full call's rows bit for bit: the prefix cache's contract."""
    q, k, v = _flash_case(cuda_device, 1, 1152, 1152, 16, 2, 128,
                          getattr(torch, dtype))
    full = ops.flash_attention(q, k, v)
    suffix = ops.flash_attention(q[:, P:].contiguous(), k, v, q_offset=P)
    torch.cuda.synchronize()
    assert torch.equal(suffix, full[:, P:])


@pytest.mark.cuda
def test_cuda_flash_row_without_keys_is_zero(cuda_device):
    q, k, v = _flash_case(cuda_device, 2, 8, 8, 4, 2, 64, torch.bfloat16)
    kv_len = torch.tensor([0, 8], dtype=torch.int32, device=cuda_device)
    out = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    assert not out[0].any() and bool(torch.isfinite(out[1].float()).all())


@pytest.mark.cuda
def test_cuda_flash_wrapper_refuses_bad_inputs(cuda_device):
    q, k, v = _flash_case(cuda_device, 1, 16, 16, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="k on cpu"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="k is torch.float32"):
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="head dim 48"):
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError, match="must be contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    flat = torch.empty(k.numel() + 8, dtype=k.dtype, device=cuda_device)
    odd = flat[1:1 + k.numel()].view(k.shape)        # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, odd, v)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=torch.tensor(
            [16], dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="do not group"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_pages,len_a,len_b", [(2, 17, 9),
                                                      (62, 30, 41)])
def test_cuda_suffix_prefill_equals_full_prefill_bitwise(cuda_device,
                                                         prefix_pages,
                                                         len_a, len_b):
    """On the card, LM prefill of only the suffix over cached prefix K/V
    reproduces the full prefill's logits and pool pages bit for bit (the
    flash kernel's suffix rows and prefill's fixed row blocks); the second
    case spans two row blocks with the suffix inside one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM
    from repro_torch.models.page_ops import PageCtx
    ptok, mpps = 8, 96
    # The smoke config at head dim 32, the kernel's smallest (bf16 pools).
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), d_model=128,
                              d_ff=256)
    lm = LM(cfg, device=cuda_device).init_weights(
        torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(prefix_pages)
    P = prefix_pages * ptok
    prefix = rng.integers(0, cfg.vocab_size, P).astype(np.int32)
    prompt_a, prompt_b = (np.concatenate([prefix, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (len_a, len_b))

    def ctx(total):
        tables = np.full((1, 1, mpps), -1, np.int32)
        ntok = np.zeros((1, 1, mpps), np.int32)
        for i in range(-(-total // ptok)):
            tables[0, 0, i] = i
            ntok[0, 0, i] = min(ptok, total - i * ptok)
        t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
        return PageCtx(tables=t(tables), ntok=t(ntok),
                       wpage=t(np.asarray([[(total - 1) // ptok]], np.int32)),
                       wslot=t(np.asarray([(total - 1) % ptok], np.int32)),
                       frame_pages=4)

    def pools():
        (shape, dtype), _ = lm.pool_shapes(mpps, ptok)
        return tuple(torch.zeros(shape, dtype=dtype, device=cuda_device)
                     for _ in range(2))

    def prefill(prompt, pl, start=0, prefix_kv=None):
        T = len(prompt)
        toks = torch.zeros((1, -(-T // ptok) * ptok - start),
                           dtype=torch.int32)
        toks[0, :T - start] = torch.from_numpy(prompt[start:])
        logits, _, _ = lm.prefill(
            {"tokens": toks.to(cuda_device)}, pl, ctx(T + 1),
            last_pos=torch.tensor([T - 1 - start], device=cuda_device),
            prefix_kv=prefix_kv, prefix_len=start)
        return logits

    pools_a = pools()
    prefill(prompt_a, pools_a)
    L = pools_a[0].shape[0]
    pk, pv = (p[:, :prefix_pages].reshape(L, 1, P, *p.shape[3:])
              for p in pools_a)
    pools_ref = pools()
    before = ops.launch_counts()["flash_attention"]
    logits_ref = prefill(prompt_b, pools_ref)
    warm = pools()
    for w, a in zip(warm, pools_a):
        w[:, :prefix_pages] = a[:, :prefix_pages]
    logits_warm = prefill(prompt_b, warm, P, (pk, pv))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2 * L
    assert torch.equal(logits_warm, logits_ref)
    n = -(-len(prompt_b) // ptok)
    for ref_pool, got in zip(pools_ref, warm):
        assert torch.equal(got[:, :n], ref_pool[:, :n])


# ------------------------------------------------------------------ SSD scan


def _ssd_case(dev, B, T, nh, hd, N, dtype, with_h0, seed=41):
    """Inputs drawn as tests/test_kernels.py draws them: dt in [0.01, 0.2],
    A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)

    def t(a, dt_=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dt_)
    x = t(rng.normal(size=(B, T, nh, hd)))
    dt = t(rng.uniform(0.01, 0.2, size=(B, T, nh)), torch.float32)
    A = -t(rng.uniform(0.5, 2.0, size=(nh,)), torch.float32)
    Bm = t(rng.normal(size=(B, T, nh, N)))
    Cm = t(rng.normal(size=(B, T, nh, N)))
    h0 = (t(rng.normal(size=(B, nh, hd, N)), torch.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("Q", [48, 64, 192, 256])
@pytest.mark.parametrize("N", [16, 64, 128])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_ssd_scan_matches_plain(cuda_device, hd, N, Q, with_h0, dtype):
    """The kernel against its plain version on the same inputs, over two
    chunks (the carried state crosses a chunk boundary) and two heads.
    Tolerances of tests/test_kernels.py: 3e-2 for bf16 inputs, 2e-4 for
    f32 (another summation order of f32 sums)."""
    tdt = getattr(torch, dtype)
    args = _ssd_case(cuda_device, 2, 2 * Q, 2, hd, N, tdt, with_h0)
    x, dt, A, Bm, Cm, h0 = args
    before = ops.launch_counts()["ssd_scan"]
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, h0=h0)
    y_r, h_r = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=Q, h0=h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert y.dtype == h.dtype == torch.float32
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y, y_r, **tol)
    torch.testing.assert_close(h, h_r, **tol)


@pytest.mark.cuda
def test_cuda_ssd_scan_single_chunk_and_smoke_dims(cuda_device):
    """T = Q (one chunk, no carried term) and the smoke configs' head dim
    and state size 16, f32 at 2e-4."""
    for B, T, nh, hd, N, Q in ((1, 40, 3, 16, 16, 40), (3, 64, 4, 16, 16,
                                                        32)):
        x, dt, A, Bm, Cm, h0 = _ssd_case(cuda_device, B, T, nh, hd, N,
                                         torch.float32, True)
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, h0=h0)
        y_r, h_r = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=Q, h0=h0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_r, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, h_r, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_ssd_scan_wrapper_refuses_bad_inputs(cuda_device):
    x, dt, A, Bm, Cm, h0 = _ssd_case(cuda_device, 1, 64, 2, 32, 16,
                                     torch.bfloat16, True)
    with pytest.raises(ValueError, match="Bm on cpu"):
        ops.ssd_scan(x, dt, A, Bm.cpu(), Cm, chunk=32)
    with pytest.raises(ValueError, match="Bm is torch.float32"):
        ops.ssd_scan(x, dt, A, Bm.float(), Cm, chunk=32)
    with pytest.raises(ValueError, match="dt must be float32"):
        ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="head dim 24"):
        ops.ssd_scan(x[..., :24].contiguous(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="chunk 48"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="chunk 512"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=512)
    with pytest.raises(ValueError, match="must be contiguous"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="h0"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32, h0=h0[:, :1].contiguous())
    flat = torch.empty(Bm.numel() + 8, dtype=Bm.dtype, device=cuda_device)
    odd = flat[1:1 + Bm.numel()].view(Bm.shape)       # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.ssd_scan(x, dt, A, odd, Cm, chunk=32)


def _grouped(t, G):
    """The first G heads' B or C as a contiguous [B, T, G, N] group tensor."""
    return t[:, :, :G].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("Q", [48, 256])
@pytest.mark.parametrize("hd,N", [(64, 64), (64, 128)])
@pytest.mark.parametrize("G", [1, 2])
def test_cuda_ssd_scan_grouped_matches_plain(cuda_device, G, hd, N, Q,
                                             with_h0, dtype):
    """B / C as G un-expanded groups of 4 heads (head h reads group
    h // (4 // G)), over two chunks: the kernel against its plain version
    (tolerances as above), and bit for bit against its own call on the
    groups repeated to every head."""
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm, h0 = _ssd_case(cuda_device, 2, 2 * Q, 4, hd, N, tdt,
                                     with_h0)
    Bg, Cg = _grouped(Bm, G), _grouped(Cm, G)
    before = ops.launch_counts()["ssd_scan"]
    y, h = ops.ssd_scan(x, dt, A, Bg, Cg, chunk=Q, h0=h0)
    y_r, h_r = ref.ssd_scan_ref(x, dt, A, Bg, Cg, chunk=Q, h0=h0)
    rep = 4 // G
    y_e, h_e = ops.ssd_scan(x, dt, A, Bg.repeat_interleave(rep, dim=2),
                            Cg.repeat_interleave(rep, dim=2), chunk=Q, h0=h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 2
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y, y_r, **tol)
    torch.testing.assert_close(h, h_r, **tol)
    assert torch.equal(y, y_e) and torch.equal(h, h_e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_ssd_scan_is_deterministic_and_row_independent(cuda_device,
                                                            dtype):
    """Two calls give the same bits; batch row 1 alone gives the bits it
    gets inside a batch of 3."""
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm, h0 = _ssd_case(cuda_device, 3, 3 * 192, 4, 64, 64,
                                     tdt, True)
    Bg, Cg = _grouped(Bm, 1), _grouped(Cm, 1)
    y, h = ops.ssd_scan(x, dt, A, Bg, Cg, chunk=192, h0=h0)
    y2, h2 = ops.ssd_scan(x, dt, A, Bg, Cg, chunk=192, h0=h0)
    one = [t[1:2].contiguous() for t in (x, dt)]
    y1, h1 = ops.ssd_scan(*one, A, Bg[1:2].contiguous(),
                          Cg[1:2].contiguous(), chunk=192,
                          h0=h0[1:2].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(y1, y[1:2]) and torch.equal(h1, h[1:2])


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("N", [64, 128])
def test_cuda_ssd_scan_main_path_chunks_match_plain(cuda_device, N,
                                                    with_h0):
    """Five 256-row chunks (T = 1280, the main path's padded prefill) with
    one group of bf16 B / C, as zamba2-1.2b (N = 64) and mamba2-1.3b
    (N = 128) call it, at 8 heads of 64: the state passes four chunk
    boundaries.  3e-2 as above."""
    x, dt, A, Bm, Cm, h0 = _ssd_case(cuda_device, 1, 1280, 8, 64, N,
                                     torch.bfloat16, with_h0)
    Bg, Cg = _grouped(Bm, 1), _grouped(Cm, 1)
    y, h = ops.ssd_scan(x, dt, A, Bg, Cg, chunk=256, h0=h0)
    y_r, h_r = ref.ssd_scan_ref(x, dt, A, Bg, Cg, chunk=256, h0=h0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    torch.testing.assert_close(y, y_r, rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(h, h_r, rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
def test_cuda_ssd_scan_refuses_groups_that_do_not_divide(cuda_device):
    x, dt, A, Bm, Cm, _ = _ssd_case(cuda_device, 1, 64, 4, 32, 16,
                                    torch.bfloat16, False)
    for G in (3, 8):
        Bg = torch.zeros((1, 64, G, 16), dtype=torch.bfloat16,
                         device=cuda_device)
        with pytest.raises(ValueError, match="groups do not divide"):
            ops.ssd_scan(x, dt, A, Bg, Bg, chunk=32)
    with pytest.raises(ValueError, match=r"one \[B, T, G, N\] shape"):
        ops.ssd_scan(x, dt, A, Bm, _grouped(Cm, 2), chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-1.3b"])
def test_cuda_recurrent_lm_matches_cpu_plain_path(cuda_device, arch):
    """The LM of the ssm and hybrid families at smoke width on the card
    (SSD-scan, flash and paged kernels) against the same weights on the
    CPU (plain versions): prefill of a 45-token prompt padded to 48 (two
    chunks of 32 and a padded third), then two decode steps; logits, the
    ssm / conv state and the pools.  f32 throughout, pools included, at
    1e-3: the kernels sum in another order than the plain versions
    (2e-4 per SSD scan), amplified through the layers and the recurrence.
    The hybrid's attention head dim is 32, the attention kernels' smallest
    (the smoke config has 16)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.models.lm import LM
    from repro_torch.serving.kv_cache import ShardedKVCache
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, head_dim=32)
    cpu = LM(cfg).init_weights(torch.Generator().manual_seed(0))
    card = LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    ptok, mpps, NP = 8, 12, 32
    T = 45
    rng = np.random.default_rng(7)
    toks = np.zeros((1, 48), np.int32)
    toks[0, :T] = rng.integers(0, cfg.vocab_size, T)
    new = torch.from_numpy(rng.integers(0, cfg.vocab_size, 2).astype(
        np.int32))
    shapes = cpu.pool_shapes(NP, ptok, dtype=torch.float32)
    runs = {}
    before = ops.launch_counts()
    for dev, lm in (("cpu", cpu), ("cuda", card)):
        cache = ShardedKVCache(PoolGeometry(page_tokens=ptok,
                                            frame_pages=4), NP, 1)
        cache.allocate(0, T)
        pl = None if shapes is None else tuple(
            torch.zeros(s, dtype=d, device=dev) for s, d in shapes)
        logits, pl, state = lm.prefill(
            {"tokens": torch.from_numpy(toks).to(dev)}, pl,
            cache.pack_ctx([0], mpps, device=dev),
            last_pos=torch.tensor([T - 1], device=dev))
        out = [logits]
        for i in range(2):
            cache.append(0)
            logits, pl, state = lm.decode_step(
                new[i:i + 1].to(dev), torch.tensor([T + i], device=dev), pl,
                cache.pack_ctx([0], mpps, device=dev), state)
            out.append(logits)
        runs[dev] = (out, state, pl)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    n_attn = card.kv_layers()
    assert after["ssd_scan"] - before["ssd_scan"] == cfg.n_layers
    assert after["flash_attention"] - before["flash_attention"] == n_attn
    assert (after["paged_attention.page"] - before["paged_attention.page"]
            == 2 * n_attn)
    tol = dict(rtol=1e-3, atol=1e-3)
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a.cpu(), b, **tol)
    for k in ("ssm", "conv"):
        torch.testing.assert_close(runs["cuda"][1][k].cpu(),
                                   runs["cpu"][1][k], **tol)
    if shapes is not None:
        for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
            torch.testing.assert_close(a.cpu(), b, **tol)


# ------------------------------------------------------------------ MLA

MLA_H, MLA_DK, MLA_DV = 16, 576, 512     # deepseek-v2-lite's latent pools


def _mla_pools(dev, NP, ptok, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pk = torch.randn((NP, ptok, 1, MLA_DK), generator=gen,
                     device=dev).to(torch.bfloat16)
    pv = torch.randn((NP, ptok, 1, MLA_DV), generator=gen,
                     device=dev).to(torch.bfloat16)
    q = torch.randn((8, MLA_H, MLA_DK), generator=gen,
                    device=dev).to(torch.bfloat16)
    return q, pk, pv


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("granularity", ["page", "frame"])
def test_cuda_mla_paged_attention_matches_plain(cuda_device, granularity, B):
    """MLA's absorbed decode shape (16 query heads on one latent KV head,
    K 576 / V 512 wide, bf16) over 32 64-token pages per row (2 frames of
    16 pages), with holes and a partial last block, and at B = 4 a row
    made only of holes."""
    rng = np.random.default_rng(21)
    ptok, fp, NP = 64, 16, 80
    q, pk, pv = _mla_pools(cuda_device, NP, ptok, seed=B)
    q = q[:B].contiguous()
    if granularity == "page":
        tables, ntok = _block_tables(rng, B, 32, NP, ptok)
    else:
        tables, ntok = _block_tables(rng, B, 2, NP // fp, fp * ptok)
    if B > 1:
        tables[-1], ntok[-1] = -1, 0
    tables, ntok = (torch.from_numpy(a).to(cuda_device)
                    for a in (tables, ntok))
    scale = 192 ** -0.5
    key = f"paged_attention.{granularity}"
    before = ops.launch_counts()[key]
    o, m, l = ops.paged_attention_kernel(q, pk, pv, tables, ntok,
                                         granularity=granularity,
                                         frame_pages=fp, scale=scale)
    o_r, m_r, l_r = ref.paged_attention_ref(
        q, pk, pv, tables, ntok, scale=scale,
        frame_pages=fp if granularity == "frame" else 1)
    torch.cuda.synchronize()
    assert ops.launch_counts()[key] == before + 1
    assert o.shape == (B, MLA_H, MLA_DV)
    live = slice(0, B - 1) if B > 1 else slice(0, 1)
    torch.testing.assert_close(o[live] / l[live, :, None],
                               o_r[live] / l_r[live, :, None], rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    if B > 1:
        assert (m[-1] == -1e30).all() and (l[-1] == 0).all() \
            and (o[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", ["page", "frame"])
def test_cuda_mla_paged_attention_splits_match_plain(cuda_device,
                                                     granularity):
    """The split layouts of _split_rows at the MLA shape (several splits
    with a partial last one, splits of holes, a row of holes)."""
    c = _split_case(cuda_device, granularity, MLA_H, 1, MLA_DK,
                    torch.bfloat16, dh_v=MLA_DV)
    o, m, l = _run_split_case(c, granularity)
    o_r, m_r, l_r = _run_split_case(c, granularity, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o[:-1] / l[:-1, :, None],
                               o_r[:-1] / l_r[:-1, :, None], rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    assert (m[-1] == -1e30).all() and (l[-1] == 0).all() and (o[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("granularity", ["page", "frame"])
def test_cuda_mla_paged_attention_row_is_bitwise_invariant(cuda_device,
                                                           granularity):
    """The split-KV contracts at the MLA shape: a row alone equals its row
    in the batch, at other page ids and with extra hole columns; and a
    batch of 3 rows gives each row's bits alone."""
    c = _split_case(cuda_device, granularity, MLA_H, 1, MLA_DK,
                    torch.bfloat16, dh_v=MLA_DV)
    _check_rows_bitwise_invariant(cuda_device, c, granularity)
    three = dict(c)
    for name in ("q", "tables", "ntok"):
        three[name] = c[name][:3].contiguous()
    got = _run_split_case(three, granularity)
    for b in range(3):
        alone = dict(c)
        for name in ("q", "tables", "ntok"):
            alone[name] = c[name][b:b + 1].contiguous()
        for x, y in zip(_run_split_case(alone, granularity), got):
            assert torch.equal(x, y[b:b + 1])


@pytest.mark.cuda
def test_cuda_mla_frames_plus_pages_equal_page_only(cuda_device):
    """Dual granularity at the MLA shape: coalesced frames through the
    frame kernel plus splintered pages through the page kernel, combined,
    equal the page kernel over the same sequences (bf16 tolerance)."""
    rng = np.random.default_rng(22)
    ptok, fp, NP, B = 64, 16, 80, 4
    q, pk, pv = _mla_pools(cuda_device, NP, ptok, seed=3)
    q = q[:B].contiguous()
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    ft = np.stack([rng.permutation(NP // fp)[:2] for _ in range(B)]
                  ).astype(np.int32)
    ft[1, 1] = -1
    fn = np.where(ft >= 0, fp * ptok, 0).astype(np.int32)
    pages = np.full((B, 32), -1, np.int32)
    pn = np.zeros((B, 32), np.int32)
    for b in range(B):
        n = int(rng.integers(1, 9))
        pages[b, :n] = rng.permutation(NP)[:n]
        pn[b, :n] = ptok
        pn[b, n - 1] = int(rng.integers(1, ptok + 1))
    scale = 192 ** -0.5
    dual = ops.paged_attention_dual(q, pk, pv, t(ft), t(fn), t(pages),
                                    t(pn), frame_pages=fp, scale=scale)
    ftp, fnp = ref.frames_to_pages(t(ft), t(fn), frame_pages=fp,
                                   page_tokens=ptok)
    o, m, l = ops.paged_attention_kernel(
        q, pk, pv, torch.cat([ftp, t(pages)], 1).contiguous(),
        torch.cat([fnp, t(pn)], 1).contiguous(), granularity="page",
        scale=scale)
    torch.cuda.synchronize()
    assert dual.shape == (B, MLA_H, MLA_DV)
    torch.testing.assert_close(dual, o / l[..., None], rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_mla_paged_wrappers_refuse_what_they_do_not_take(cuda_device):
    """The fused kernel keeps equal widths; the MLA shape is bf16 only;
    other value widths are refused."""
    q, pk, pv = _mla_pools(cuda_device, 4, 8, seed=4)
    tb = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    sl = torch.full((1, 2), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="value head dim 512"):
        ops.fused_paged_attention_kernel(q[:1], pk, pv, pk[:0], pv[:0], tb,
                                         sl, tb)
    with pytest.raises(ValueError, match="takes bf16"):
        ops.paged_attention_kernel(q[:1].float(), pk, pv, tb, tb,
                                   granularity="page")
    with pytest.raises(ValueError, match="value head dim 256"):
        ops.paged_attention_kernel(q[:1], pk, pv[..., :256].contiguous(),
                                   tb, tb, granularity="page")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv", [(16, 16), (8, 4)])
@pytest.mark.parametrize("Tq,Tk,q_offset,with_len,causal", [
    (200, 200, 0, False, True),     # full prefill, lengths off the tiles
    (77, 300, 223, False, True),    # suffix prefill over a cached prefix
    (130, 130, 0, True, False),     # non-causal, rows cut at kv_len
])
def test_cuda_flash_mla_widths_match_plain(cuda_device, H, n_kv, dtype, Tq,
                                           Tk, q_offset, with_len, causal):
    """Keys 192 wide (nope 128 + rope 64), values 128 wide: MLA's expanded
    prefill (H = n_kv = 16) and a grouped case; bf16 on the tensor cores,
    f32 on the CUDA cores."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(34)
    q = torch.randn((2, Tq, H, 192), generator=gen,
                    device=cuda_device).to(tdt)
    k = torch.randn((2, Tk, n_kv, 192), generator=gen,
                    device=cuda_device).to(tdt)
    v = torch.randn((2, Tk, n_kv, 128), generator=gen,
                    device=cuda_device).to(tdt)
    kv_len = (torch.tensor([Tk, Tk - 37], dtype=torch.int32,
                           device=cuda_device) if with_len else None)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              scale=192 ** -0.5)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, Tq, H, 128) and got.dtype == tdt
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_mla_suffix_rows_equal_full_rows_bitwise(cuda_device,
                                                            dtype):
    """At dh 192 / dh_v 128 a suffix call from position 576 gives the full
    1152-token call's rows bit for bit."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    q = torch.randn((1, 1152, 16, 192), generator=gen,
                    device=cuda_device).to(tdt)
    k = torch.randn((1, 1152, 16, 192), generator=gen,
                    device=cuda_device).to(tdt)
    v = torch.randn((1, 1152, 16, 128), generator=gen,
                    device=cuda_device).to(tdt)
    full = ops.flash_attention(q, k, v, scale=192 ** -0.5)
    suffix = ops.flash_attention(q[:, 576:].contiguous(), k, v, q_offset=576,
                                 scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(suffix, full[:, 576:])


@pytest.mark.cuda
def test_cuda_moe_block_bf16_matches_f32(cuda_device):
    """deepseek-v2-lite's MoE layer at full width (d_model 2048, 64 experts
    of 1408, top-6, 2 shared) over 256 tokens: the bf16 block on the card
    against the same block in f32 on the f32 copies of the bf16 weights and
    inputs.  The router's bf16 logits may reorder a near-tie, which sends
    a token to another expert, so the routing must agree on at least 95 %
    of the tokens and the outputs are compared on those at the bf16
    tolerance (2e-2 relative to the output's scale)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    p16 = moe.MoEParams(cfg, 1, torch.bfloat16, cuda_device)
    p16.init_(torch.Generator(device=cuda_device).manual_seed(0))
    lp16 = {n: w[0] for n, w in p16.named_parameters()}
    lp32 = {n: w.float() for n, w in lp16.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x16 = torch.randn((1, 256, cfg.d_model), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    y16, aux16 = moe.moe_block(cfg, lp16, x16)
    y32, aux32 = moe.moe_block(cfg, lp32, x16.float())
    r16 = moe.route(cfg, lp16["router"], x16)
    r32 = moe.route(cfg, lp32["router"], x16.float())
    torch.cuda.synchronize()
    same = ((r16[2] == r32[2]) & (r16[4] == r32[4])).all(-1)[0]
    assert float(same.float().mean()) >= 0.95
    assert bool(torch.isfinite(y16.float()).all())
    scale = float(y32.abs().max())
    err = float((y16.float() - y32)[0, same].abs().max())
    assert err <= 2e-2 * scale, (err, scale)
    assert abs(float(aux16) - float(aux32)) < 0.05 * float(aux32)


@pytest.mark.cuda
def test_cuda_moe_block_gradients_are_deterministic(cuda_device):
    """deepseek-v2-lite's MoE layer at full width, bf16, over 2 x 512
    tokens at a capacity that drops entries: two forward and backward runs
    give the same output, aux and gradients bit for bit.  The dispatch
    (``index_copy_``) writes each kept slot once and the combine's backward
    (``index_add_``) sums one row into each kept slot; only the dropped
    entries share an address, slot C, and carry exact zeros."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    p16 = moe.MoEParams(cfg, 1, torch.bfloat16, cuda_device)
    p16.init_(torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((2, 512, cfg.d_model), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(x.dtype)
    runs = []
    for _ in range(2):
        lp = {n: w[0].detach().clone().requires_grad_()
              for n, w in p16.named_parameters()}
        xx = x.clone().requires_grad_()
        y, aux = moe.moe_block(cfg, lp, xx)
        ((y.float() * dy.float()).sum() + aux).backward()
        runs.append([y.detach(), aux.detach(), xx.grad]
                    + [lp[n].grad for n in sorted(lp)])
    keep = moe.route(cfg, p16.router[0], x)[4]
    torch.cuda.synchronize()
    assert bool((~keep).any())
    for a, b in zip(*runs):
        assert bool(torch.isfinite(a.float()).all()) and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_moe_lm_matches_cpu_plain_path(cuda_device):
    """dbrx's smoke config at head dim 32 (the attention kernels'
    smallest) on the card (flash and paged kernels, cuBLAS experts)
    against the same weights on the CPU (plain versions): prefill of a
    45-token prompt padded to 48, then two decode steps; logits and pools,
    f32 throughout, at 1e-3 as the recurrent families' check above (both
    devices must also route every token to the same experts: a different
    choice would move the logits far beyond it)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.models.lm import LM
    from repro_torch.serving.kv_cache import ShardedKVCache
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"),
                              dtype="float32", d_model=128, n_heads=4)
    cpu = LM(cfg).init_weights(torch.Generator().manual_seed(0))
    card = LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    ptok, mpps, NP, T = 8, 12, 32, 45
    rng = np.random.default_rng(8)
    toks = np.zeros((1, 48), np.int32)
    toks[0, :T] = rng.integers(0, cfg.vocab_size, T)
    new = torch.from_numpy(rng.integers(0, cfg.vocab_size, 2).astype(
        np.int32))
    shapes = cpu.pool_shapes(NP, ptok, dtype=torch.float32)
    runs = {}
    before = ops.launch_counts()
    for dev, lm in (("cpu", cpu), ("cuda", card)):
        cache = ShardedKVCache(PoolGeometry(page_tokens=ptok,
                                            frame_pages=4), NP, 1)
        cache.allocate(0, T)
        pl = tuple(torch.zeros(s, dtype=d, device=dev) for s, d in shapes)
        logits, pl, _ = lm.prefill(
            {"tokens": torch.from_numpy(toks).to(dev)}, pl,
            cache.pack_ctx([0], mpps, device=dev),
            last_pos=torch.tensor([T - 1], device=dev))
        out = [logits]
        for i in range(2):
            cache.append(0)
            logits, pl, _ = lm.decode_step(
                new[i:i + 1].to(dev), torch.tensor([T + i], device=dev), pl,
                cache.pack_ctx([0], mpps, device=dev))
            out.append(logits)
        runs[dev] = (out, pl)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] \
        == cfg.n_layers
    assert (after["paged_attention.page"] - before["paged_attention.page"]
            == 2 * cfg.n_layers)
    tol = dict(rtol=1e-3, atol=1e-3)
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a.cpu(), b, **tol)
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, **tol)


@pytest.mark.cuda
def test_cuda_encdec_lm_counts_flash_by_site(cuda_device):
    """seamless's smoke config at head dim 32 (the kernels' smallest) on
    the card: one prefill and one decode
    step launch the flash kernel once per encoder layer, twice per decoder
    layer at prefill (self- and cross-attention) and once per decoder
    layer at decode, and the wrapper counts the encoder's and the
    cross-attention's launches by call site."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.models.lm import LM
    from repro_torch.serving.kv_cache import ShardedKVCache
    cfg = dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                              dtype="bfloat16", d_model=128)
    e = cfg.encdec
    lm = LM(cfg, device=cuda_device).init_weights(
        torch.Generator(device=cuda_device).manual_seed(0))
    ptok, mpps, NP, T = 8, 12, 32, 16
    cache = ShardedKVCache(PoolGeometry(page_tokens=ptok, frame_pages=4),
                           NP, 1)
    cache.allocate(0, T)
    pl = tuple(torch.zeros(s, dtype=d, device=cuda_device)
               for s, d in lm.pool_shapes(NP, ptok))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, T),
                                     generator=gen).int().to(cuda_device),
             "src_embeds": torch.randn((1, e.source_len, cfg.d_model),
                                       generator=gen).to(cuda_device,
                                                         torch.bfloat16)}
    ops.reset_launch_counts()
    _, pl, state = lm.prefill(batch, pl, cache.pack_ctx([0], mpps,
                                                        device=cuda_device),
                              last_pos=torch.tensor([T - 1],
                                                    device=cuda_device))
    cache.append(0)
    lm.decode_step(batch["tokens"][:, -1], torch.tensor([T],
                                                        device=cuda_device),
                   pl, cache.pack_ctx([0], mpps, device=cuda_device), state)
    torch.cuda.synchronize()
    assert ops.flash_site_counts() == {
        "flash_attention.encoder": e.enc_layers,
        "flash_attention.cross_prefill": e.dec_layers,
        "flash_attention.cross_decode": e.dec_layers}
    assert ops.launch_counts()["flash_attention"] \
        == e.enc_layers + 3 * e.dec_layers


@pytest.mark.cuda
def test_cuda_spill_store_round_trip_of_gathered_bf16_pages(cuda_device,
                                                           tmp_path):
    """Pages gathered off a bf16 pool by the card's ``page_gather`` go to
    disk in one spill frame and come back with the same dtype, shape and
    bits; ``page_scatter`` lands them in another pool bit for bit."""
    from repro_torch.serving.host_tier import SpillStore
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    L, NP, ptok, n_kv, dh = 36, 80, 64, 2, 128     # qwen2.5-3b's pool
    pool = torch.randn((L, NP, ptok, n_kv, dh), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    ids = [3, 4, 5, 17, 40, 41, 79]
    idx = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    pages = ops.page_gather(pool, idx).cpu()       # [L, n, ptok, kv, dh]
    payloads = [(pages[:, i], pages[:, i].flip(-1)) for i in range(len(ids))]
    keys = [(7, 0, i) for i in range(len(ids))]
    with SpillStore(str(tmp_path)) as store:
        store.write_frame(0, 0, list(zip(keys, payloads)))
        back = store.read_frame(0, expect_domain=0)
    assert [k for k, _ in back] == keys
    for (_, (k, v)), (k0, v0) in zip(back, payloads):
        assert k.dtype == torch.bfloat16 and k.shape == k0.shape
        assert torch.equal(k.view(torch.int16), k0.view(torch.int16))
        assert torch.equal(v.view(torch.int16), v0.view(torch.int16))
    other = torch.zeros_like(pool)
    ops.page_scatter(other, idx, torch.stack([k for _, (k, _v) in back],
                                             dim=1).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(other[:, idx.long()].view(torch.int16),
                       pool[:, idx.long()].view(torch.int16))


@pytest.mark.cuda
def test_cuda_cluster_agreement_with_the_cpu(cuda_device):
    """chip_smoke.py's phase 8d: phases 8a and 8b with a narrow f32 model
    on the card (kernels) and on the CPU (plain versions) give identical
    tokens, router decisions, tier counters and injector logs."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    from repro_torch.configs import get_config
    cs.phase_cluster_agreement(get_config("qwen2.5-3b"))


# ------------------------------------------------------------ training


# (H, n_kv, dh): the training kernels' tensor-core head dims and g values,
# and the CUDA-core path's widest head dim.
TRAIN_SHAPES = [
    (16, 2, 128),     # qwen2.5-3b
    (4, 4, 32),       # MHA, smallest head dim (the narrow config's)
    (32, 2, 64),      # 16 query heads per KV head
    (6, 2, 96),       # 3 query heads per KV head: rows that do not tile
    (48, 8, 128),     # 6 query heads per KV head
    (8, 1, 256),      # CUDA-core path in bf16 too, > 48 KB shared memory
    (64, 1, 64),      # MAX_GROUP: a cluster of 4 CTAs, 16 heads each
]
# (Tq, Tk, causal): full causal attention off the tiles, and non-causal
# with Tq != Tk, neither a multiple of 64.
TRAIN_CASES = [(200, 200, True), (77, 141, False)]


def _train_tol(dtype):
    # bf16: the kernels round P and dS to bf16 as mma inputs, the plain
    # version keeps them in f32 (2e-2 of each gradient's scale); f32: the
    # same arithmetic in another summation order.
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _assert_scaled(got, want, tol):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", TRAIN_SHAPES)
@pytest.mark.parametrize("Tq,Tk,causal", TRAIN_CASES)
def test_cuda_flash_forward_with_lse(cuda_device, H, n_kv, dh, dtype, Tq, Tk,
                                     causal):
    """The training forward: o bit for bit the serving call's, lse against
    its plain version (f32 2e-5; bf16 1e-4, the same bf16 products summed
    in another order)."""
    q, k, v = _flash_case(cuda_device, 2, Tq, Tk, H, n_kv, dh,
                          getattr(torch, dtype))
    before = ops.train_launch_counts()["flash_attention.train"]
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    serve = ops.flash_attention(q, k, v, causal=causal)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.train_launch_counts()["flash_attention.train"] == before + 1
    assert torch.equal(o.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32),
                       serve.view(torch.int16 if dtype == "bfloat16"
                                  else torch.int32))
    assert lse.shape == (2, H, Tq) and lse.dtype == torch.float32
    tol = 2e-5 if dtype == "float32" else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    torch.testing.assert_close(o.float(), want_o.float(),
                               **(dict(rtol=2e-2, atol=2e-2)
                                  if dtype == "bfloat16"
                                  else dict(rtol=2e-5, atol=2e-5)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,dh", TRAIN_SHAPES)
@pytest.mark.parametrize("Tq,Tk,causal", TRAIN_CASES)
def test_cuda_flash_backward_matches_plain(cuda_device, H, n_kv, dh, dtype,
                                           Tq, Tk, causal):
    q, k, v = _flash_case(cuda_device, 2, Tq, Tk, H, n_kv, dh,
                          getattr(torch, dtype))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(q.dtype)
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    before = ops.train_launch_counts()["flash_attention_bwd"]
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert ops.train_launch_counts()["flash_attention_bwd"] == before + 1
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert bool(torch.isfinite(g.float()).all())
        _assert_scaled(g, w, _train_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv,Tq,Tk,causal", [
    (16, 2, 333, 333, True),      # g = 8: clusters of 4, 2 heads a rank
    (32, 2, 333, 333, True),      # g = 16: 4 heads a rank
    (16, 2, 300, 700, False),     # non-causal, Tq != Tk
])
def test_cuda_flash_backward_is_deterministic(cuda_device, dtype, H, n_kv,
                                              Tq, Tk, causal):
    """No atomics: the g heads' dK / dV partials are summed in rank order,
    so two backward calls give the same bits, and autograd through the
    flash call gives the wrapper's gradients."""
    q, k, v = _flash_case(cuda_device, 2, Tq, Tk, H, n_kv, 128,
                          getattr(torch, dtype))
    do = torch.randn(q.shape, device=cuda_device).to(q.dtype)
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    a = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    b = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qq, kk, vv, causal=causal)
    c = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert torch.equal(out, o)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("H,n_kv,T", [
    (8, 1, 2048),     # qwen2.5-3b's tp = 2 shard (chip_smoke rows 7tp / 9tp)
    (4, 1, 333),      # its tp = 4 shard
    (24, 4, 333),     # dbrx-132b's tp = 2 shard
])
def test_cuda_flash_train_kernels_at_a_tensor_parallel_shard(cuda_device, H,
                                                             n_kv, T):
    """The training forward with lse and the backward at a shard's head
    counts (H / tp query heads over its kv block), bf16, causal: o bit for
    bit the serving call's, lse at 1e-4, o and the gradients at 2e-2 of
    their plain versions' scale, two backward calls bitwise.  The kv block
    a shard slices out of the whole k / v (made contiguous, as the
    Megatron attention hands it over) gives the same bits as a kv tensor
    of that block alone."""
    q, k, v = _flash_case(cuda_device, 2, T, T, H, n_kv, 128, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(q.dtype)
    o, lse = ops.flash_attention_lse(q, k, v, causal=True)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True)
    whole = torch.cat([k, torch.zeros_like(k)], dim=2)  # 2 n_kv heads
    sliced = ops.flash_attention(q, whole[:, :, :n_kv].contiguous(),
                                 torch.cat([v, v], dim=2)[:, :, :n_kv]
                                 .contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, ops.flash_attention(q, k, v, causal=True))
    assert torch.equal(sliced, o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=2e-2,
                               atol=2e-2)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        _assert_scaled(g, w, 2e-2)


def _mla_case(dev, B, Tq, Tk, H, n_kv, dtype, seed=37):
    """q [B, Tq, H, 192], k [B, Tk, n_kv, 192] and v [B, Tk, n_kv, 128]:
    MLA's expanded attention (nope 128 + rope 64 keys, 128-wide values)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, Tq, H, 192), (B, Tk, n_kv, 192),
                               (B, Tk, n_kv, 128)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,n_kv", [(16, 16), (8, 2)])
@pytest.mark.parametrize("Tq,Tk,causal", TRAIN_CASES + [(333, 333, True)])
def test_cuda_flash_mla_widths_train_kernels_match_plain(cuda_device, H, n_kv,
                                                         dtype, Tq, Tk,
                                                         causal):
    """The training forward and backward at dh 192 / dh_v 128 (bf16 on the
    tensor cores, f32 on CUDA cores): o [.., 128] bit for bit the serving
    call's, lse and the gradients (dq and dk 192 wide, dv 128) against
    their plain versions at the tolerances above, two backward calls
    bitwise, and autograd through the flash call gives the wrapper's."""
    dt = getattr(torch, dtype)
    q, k, v = _mla_case(cuda_device, 2, Tq, Tk, H, n_kv, dt)
    scale = 192 ** -0.5
    do = torch.randn((2, Tq, H, 128), device=cuda_device).to(dt)
    o, lse = ops.flash_attention_lse(q, k, v, causal=causal, scale=scale)
    serve = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    want_o, want_lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                                   scale=scale)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  scale=scale)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    scale=scale)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       scale=scale)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qq, kk, vv, causal=causal, scale=scale)
    auto = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert o.shape == (2, Tq, H, 128) and torch.equal(o, serve)
    assert torch.equal(out, o)
    tol = 2e-5 if dtype == "float32" else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    _assert_scaled(o, want_o, _train_tol(dtype))
    for g, g2, g3, w, x in zip(got, again, auto, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert bool(torch.isfinite(g.float()).all())
        assert torch.equal(g, g2) and torch.equal(g, g3)
        _assert_scaled(g, w, _train_tol(dtype))


@pytest.mark.cuda
def test_cuda_flash_backward_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _flash_case(cuda_device, 1, 64, 64, 4, 2, 64, torch.bfloat16)
    o, lse = ops.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, o, lse[:, :, :10].contiguous())
    with pytest.raises(ValueError, match="do"):
        ops.flash_attention_bwd(q, k, v, o, o.float(), lse)
    # MLA's widths: o and dO are as wide as the values (128), not the keys.
    qm, km, vm = _mla_case(cuda_device, 1, 64, 64, 4, 1, torch.bfloat16)
    om, lsem = ops.flash_attention_lse(qm, km, vm)
    assert om.shape == (1, 64, 4, 128)
    with pytest.raises(ValueError, match="do"):
        ops.flash_attention_bwd(qm, km, vm, om, torch.zeros_like(qm), lsem)


@pytest.mark.cuda
def test_cuda_trainer_step_matches_the_cpu(cuda_device):
    """Two Trainer steps of a narrow f32 model (head dim 32) on the card
    (kernels) and on the CPU (plain versions) from the same weights: each
    step's loss and grad norm within 1e-4 relative (f32, other summation
    order; TF32 off), and the card's launches: per step two training
    forwards (remat recomputes) and one backward per layer."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2,
                              d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                              vocab_size=512, dtype="float32")
    hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=4, remat="block")
    params = None
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, hp, batch_per_step=2, seq_len=96, device=dev,
                     params=params)
        if params is None:
            params = {n: p.detach().cpu().clone()
                      for n, p in tr.lm.named_parameters()}
        ops.reset_launch_counts()
        tr.run(2, log_every=1)
        runs[dev] = (tr.log, ops.train_launch_counts())
    (log_gpu, c_gpu), (log_cpu, c_cpu) = runs["cuda"], runs["cpu"]
    for a, b in zip(log_gpu, log_cpu):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    assert c_gpu == {"flash_attention.train": 2 * 2 * cfg.n_layers,
                     "flash_attention_bwd": 2 * cfg.n_layers,
                     "ssd_scan_bwd": 0}
    assert c_cpu == {"flash_attention.train": 0, "flash_attention_bwd": 0,
                     "ssd_scan_bwd": 0}


@pytest.mark.cuda
def test_cuda_nccl_world_one_trainer_matches_the_cpu(cuda_device, tmp_path):
    """chip_smoke.py's phase 9j (b): the narrow f32 model's Trainer on a
    one-rank NCCL group (megatron + ZeRO-1 + grad_compress, then fsdp), 4
    steps each, against the same on a one-rank gloo group on the CPU: every
    loss within 1e-4 relative (the standing training gate)."""
    from pathlib import Path
    from repro_torch.launch.spawn import run_ranks
    root = str(Path(__file__).resolve().parents[1])
    runs = {dev: run_ranks("chip_smoke:dist_rank", 1, device=dev,
                           args=[dict(part="narrow",
                                      ckpt_dir=str(tmp_path / dev))],
                           paths=[root], timeout=300)[0]
            for dev in ("cuda", "cpu")}
    for name in ("megatron", "fsdp"):
        card, cpu = runs["cuda"][name], runs["cpu"][name]
        assert len(card) == len(cpu) == 4
        for a, b in zip(card, cpu):
            assert a == pytest.approx(b, rel=1e-4), name


# ------------------------------------------------------- SSD-scan backward


def _ssd_bwd_case(dev, B, T, nh, hd, N, G, dtype, with_h0, with_dh, seed=43):
    """_ssd_case's inputs with B / C as G groups, plus dy and (with_dh) the
    final state's gradient, f32."""
    x, dt, A, Bm, Cm, h0 = _ssd_case(dev, B, T, nh, hd, N, dtype, with_h0,
                                     seed)
    Bm, Cm = (t[:, :, :G].contiguous() for t in (Bm, Cm))
    gen = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((B, T, nh, hd), generator=gen, device=dev)
    dh = torch.randn((B, nh, hd, N), generator=gen, device=dev) \
        if with_dh else None
    return (x, dt, A, Bm, Cm, h0), dy, dh


def _check_scaled(got, want, tol, what):
    """|got - want| <= tol * max |want|, each gradient at its own scale."""
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                          want):
        if w is None:
            assert g is None, (what, name)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert bool(torch.isfinite(g.float()).all()), (what, name)
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        assert err <= tol * scale, (what, name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd,N,Q", [(64, 128, 256), (64, 64, 256),
                                    (16, 16, 32), (64, 64, 48),
                                    (64, 128, 96), (64, 64, 80),
                                    (64, 128, 160), (16, 16, 80)])
def test_cuda_ssd_scan_bwd_matches_plain(cuda_device, hd, N, Q, dtype,
                                         grouped, with_h0):
    """The hand-written backward against its plain version (autograd
    through ``ssd_scan_ref`` on the card) over three chunks and four heads,
    B / C as one group (a CTA of the bf16 pair passes walks all four heads)
    or head-expanded (one head a CTA), with and without h0 and the final
    state's gradient: 2e-2 of each gradient's scale for bf16 inputs, 2e-5
    for f32 (f32 sums in another order); two calls bit for bit.  Q 48 is
    one partial 64-row tile; Q 80, 96 and 160 end in a partial tile on
    both sides of the diagonal."""
    tdt = getattr(torch, dtype)
    nh = 4
    G = 1 if grouped else nh
    args, dy, dh = _ssd_bwd_case(cuda_device, 2, 3 * Q, nh, hd, N, G, tdt,
                                 with_h0, with_dh=with_h0)
    x, dt, A, Bm, Cm, h0 = args
    before = ops.train_launch_counts()["ssd_scan_bwd"]
    got = ops.ssd_scan_bwd(*args[:5], dy, dh, chunk=Q, h0=h0)
    again = ops.ssd_scan_bwd(*args[:5], dy, dh, chunk=Q, h0=h0)
    want = ref.ssd_scan_bwd_ref(*args[:5], dy, dh, chunk=Q, h0=h0)
    torch.cuda.synchronize()
    assert ops.train_launch_counts()["ssd_scan_bwd"] == before + 2
    _check_scaled(got, want, 2e-2 if dtype == "bfloat16" else 2e-5,
                  (hd, N, Q, dtype, G, with_h0))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_ssd_scan_autograd_forward_bitwise_and_grads(cuda_device,
                                                          dtype):
    """Under grad mode ``ops.ssd_scan`` runs SSDScanFn: its outputs are bit
    for bit the ``no_grad`` call's, and autograd's gradients of a loss on
    y alone are the backward's with dh = 0."""
    tdt = getattr(torch, dtype)
    args, dy, _ = _ssd_bwd_case(cuda_device, 2, 512, 4, 64, 64, 1, tdt,
                                True, False)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = ops.ssd_scan(*leaves[:5], chunk=256, h0=leaves[5])
    with torch.no_grad():
        y0, h0_ = ops.ssd_scan(*args[:5], chunk=256, h0=args[5])
    assert torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0_)
    assert "SSDScanFn" in type(y.grad_fn).__name__
    (y * dy).sum().backward()
    want = ops.ssd_scan_bwd(*args[:5], dy, None, chunk=256, h0=args[5])
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_refuses_what_it_does_not_take(cuda_device):
    """Head dim / state size pairs outside BWD_DIMS, a dy that is not f32
    and a dh of the wrong shape raise."""
    args, dy, dh = _ssd_bwd_case(cuda_device, 1, 64, 2, 32, 32, 1,
                                 torch.float32, False, True)
    with pytest.raises(ValueError, match="backward takes"):
        ops.ssd_scan_bwd(*args[:5], dy, dh, chunk=32)
    args, dy, dh = _ssd_bwd_case(cuda_device, 1, 64, 2, 64, 64, 1,
                                 torch.float32, False, True)
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(*args[:5], dy.half(), dh, chunk=32)
    with pytest.raises(ValueError, match="dh"):
        ops.ssd_scan_bwd(*args[:5], dy, dh[:, :1], chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2",
                                  "deepseek-v2-lite-16b", "dbrx-132b"])
def test_cuda_family_train_step_matches_the_cpu(cuda_device, arch):
    """chip_smoke.py's phase 9h for one family: the narrow f32 model
    trained 2 steps on the card and on the CPU from the same weights, each
    step's loss and the first step's grad norm within 1e-4 relative (a MoE
    model's CPU run takes the card's expert choices); the card's launches
    account for its attention and SSD layers."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.family_train_agreement(arch, "cuda", steps=2)
