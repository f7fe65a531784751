"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where only PyTorch is installed
(``--noconftest`` keeps pytest from loading tests/conftest.py, which
imports JAX and the reference package).  Every test here is marked
``cuda`` and skips without a CUDA device; on one, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: normalized attention 2e-2 for bf16 and 2e-5 for f32 inputs, as
tests/test_kernels.py (other summation order and rounding points); the
f32 accumulators m and l 1e-5; copies exact.  The fused gather-attend
kernel is also held bitwise to the page kernel where it reads the same
bytes.
"""

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
