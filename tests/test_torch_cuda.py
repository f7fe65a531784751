"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs where only PyTorch is installed
(``--noconftest`` keeps pytest from loading tests/conftest.py, which
imports JAX and the reference package).  Every test here is marked
``cuda`` and skips without a CUDA device; on one, run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: normalized attention 2e-2 for bf16 and 2e-5 for f32 inputs, as
tests/test_kernels.py (other summation order and rounding points); the
f32 accumulators m and l 1e-5; copies exact.
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
