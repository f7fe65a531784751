"""Port kernels' plain versions vs the reference's Pallas kernels.

The reference kernels run in Pallas interpret mode on the CPU, as the
reference's own tests run them; the port's wrappers run their plain
PyTorch versions for CPU tensors.  Inputs are drawn with numpy from a seed
and handed to both.  Tolerances: f32 2e-5 and bf16 2e-2 (those of
tests/test_kernels.py: bf16 inputs round at other places in the two
frameworks, f32 sums run in another order), exact for the page copies.
The CUDA kernels themselves are held against the same plain versions on
the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.page_compact import page_compact as j_compact
from repro.kernels.page_compact import page_gather as j_gather
from repro.kernels.page_compact import page_scatter as j_scatter
from repro.kernels.paged_attention import paged_attention_kernel as j_paged
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _to_torch(a, dtype):
    """Same values in both frameworks: numpy f32 -> torch dtype."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _from_jax(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


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


CASES = [  # B, H, n_kv, dh, ptok, fp
    (2, 8, 4, 32, 16, 4),
    (3, 8, 2, 16, 8, 4),     # the smoke config's GQA shape
    (1, 4, 4, 64, 16, 2),    # MHA
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("granularity", ["page", "frame"])
@pytest.mark.parametrize("B,H,n_kv,dh,ptok,fp", CASES)
def test_paged_attention_plain_matches_pallas(B, H, n_kv, dh, ptok, fp,
                                              granularity, dtype):
    rng = np.random.default_rng(11)
    jdt, tdt = DTYPES[dtype]
    NP = 8 * fp
    pk = rng.normal(size=(NP, ptok, n_kv, dh)).astype(np.float32)
    pv = rng.normal(size=(NP, ptok, n_kv, dh)).astype(np.float32)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    if granularity == "page":
        tables, ntok = _block_tables(rng, B, 6, NP, ptok)
    else:
        tables, ntok = _block_tables(rng, B, 3, NP // fp, fp * ptok)
    if B > 1:
        tables[-1], ntok[-1] = -1, 0     # a row made only of holes
    scale = dh ** -0.5
    o_j, m_j, l_j = j_paged(jnp.asarray(q, jdt), jnp.asarray(pk, jdt),
                            jnp.asarray(pv, jdt), jnp.asarray(tables),
                            jnp.asarray(ntok), granularity=granularity,
                            frame_pages=fp, scale=scale)
    o_t, m_t, l_t = ops.paged_attention_kernel(
        _to_torch(q, tdt), _to_torch(pk, tdt), _to_torch(pv, tdt),
        torch.from_numpy(tables), torch.from_numpy(ntok),
        granularity=granularity, frame_pages=fp, scale=scale)
    tol = _tol(dtype)
    np.testing.assert_allclose(m_t.numpy(), _from_jax(m_j), **tol)
    np.testing.assert_allclose(l_t.numpy(), _from_jax(l_j), **tol)
    out_j = _from_jax(o_j) / np.maximum(_from_jax(l_j)[..., None], 1e-30)
    out_t = (o_t / torch.clamp(l_t[..., None], min=1e-30)).numpy()
    np.testing.assert_allclose(out_t, out_j, **tol)
    if B > 1:   # a row made only of holes: m = -1e30, l = 0, o = 0
        assert (m_t[-1] == -1e30).all() and (l_t[-1] == 0).all()
        assert (o_t[-1] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_dual_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    jdt, tdt = DTYPES[dtype]
    B, H, n_kv, dh, ptok, fp = 3, 8, 2, 32, 8, 4
    NP = 12 * fp
    pk = rng.normal(size=(NP, ptok, n_kv, dh)).astype(np.float32)
    pv = rng.normal(size=(NP, ptok, n_kv, dh)).astype(np.float32)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    ft, fn = _block_tables(rng, B, 2, NP // fp, fp * ptok)
    fn = np.where(ft >= 0, fp * ptok, 0).astype(np.int32)   # full frames
    pt, pn = _block_tables(rng, B, 8, NP, ptok)
    scale = dh ** -0.5
    out_j = jops.paged_attention_dual(
        jnp.asarray(q, jdt), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt),
        jnp.asarray(ft), jnp.asarray(fn), jnp.asarray(pt), jnp.asarray(pn),
        frame_pages=fp, scale=scale, use_pallas=True)
    out_t = ops.paged_attention_dual(
        _to_torch(q, tdt), _to_torch(pk, tdt), _to_torch(pv, tdt),
        torch.from_numpy(ft), torch.from_numpy(fn), torch.from_numpy(pt),
        torch.from_numpy(pn), frame_pages=fp, scale=scale)
    np.testing.assert_allclose(out_t.float().numpy(), _from_jax(out_j),
                               **_tol(dtype))


IDX_CASES = {
    "mixed": [5, -1, 0, 17, -1, 9],
    "all_holes": [-1, -1, -1],
    "no_holes": [3, 1, 30, 2],
}


def _pool(rng, dtype, NP=32, ptok=8, kv=2, dh=16):
    return rng.normal(size=(NP, ptok, kv, dh)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(IDX_CASES))
def test_page_gather_matches_pallas(case, dtype):
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[dtype]
    pool = _pool(rng, dtype)
    idx = np.asarray(IDX_CASES[case], np.int32)
    want = _from_jax(j_gather(jnp.asarray(pool, jdt), jnp.asarray(idx)))
    got = ops.page_gather(_to_torch(pool, tdt)[None], torch.from_numpy(idx))
    np.testing.assert_array_equal(got[0].float().numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(IDX_CASES))
def test_page_scatter_matches_pallas(case, dtype):
    rng = np.random.default_rng(4)
    jdt, tdt = DTYPES[dtype]
    pool = _pool(rng, dtype)
    idx = np.asarray(IDX_CASES[case], np.int32)
    pages = rng.normal(size=(len(idx), *pool.shape[1:])).astype(np.float32)
    want = _from_jax(j_scatter(jnp.asarray(pool, jdt), jnp.asarray(idx),
                               jnp.asarray(pages, jdt)))
    tpool = _to_torch(pool, tdt)[None].clone()
    out = ops.page_scatter(tpool, torch.from_numpy(idx),
                           _to_torch(pages, tdt)[None])
    assert out is tpool                                  # updated in place
    np.testing.assert_array_equal(tpool[0].float().numpy(), want)


COMPACT_CASES = {
    "mixed": ([4, -1, 7, 20], [11, 2, -1, 25]),
    "all_holes": ([-1, -1], [-1, -1]),
    "no_holes": ([0, 1, 2], [30, 29, 28]),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_page_compact_matches_pallas(case, dtype):
    rng = np.random.default_rng(6)
    jdt, tdt = DTYPES[dtype]
    pool = _pool(rng, dtype)
    src, dst = (np.asarray(a, np.int32) for a in COMPACT_CASES[case])
    want = _from_jax(j_compact(jnp.asarray(pool, jdt), jnp.asarray(src),
                               jnp.asarray(dst)))
    tpool = _to_torch(pool, tdt)[None].clone()
    ops.page_compact(tpool, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(tpool[0].float().numpy(), want)


def test_page_ops_cover_every_layer():
    """Stacked [L, NP, ...] pools: one call moves the page in every layer."""
    rng = np.random.default_rng(8)
    pool = torch.from_numpy(rng.normal(size=(3, 16, 4, 2, 8))
                            .astype(np.float32))
    idx = torch.tensor([2, -1, 9], dtype=torch.int32)
    got = ops.page_gather(pool, idx)
    assert got.shape == (3, 3, 4, 2, 8)
    for layer in range(3):
        assert torch.equal(got[layer, 2], pool[layer, 9])
        assert torch.equal(got[layer, 1], pool[layer, 0])   # hole -> page 0
    before = pool.clone()
    ops.page_compact(pool, torch.tensor([9, -1], dtype=torch.int32),
                     torch.tensor([4, 5], dtype=torch.int32))
    assert torch.equal(pool[:, 4], before[:, 9])
    assert torch.equal(pool[:, 5], before[:, 5])


def test_wrappers_refuse_devices_without_a_path():
    q = torch.zeros((1, 4, 32), device="meta")
    pool = torch.zeros((4, 8, 2, 32), device="meta")
    tb = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no paged-attention path"):
        ops.paged_attention_kernel(q, pool, pool, tb, tb, granularity="page")
    with pytest.raises(ValueError, match="granularity"):
        ops.paged_attention_kernel(q, pool, pool, tb, tb, granularity="x")


def test_launch_counts_stay_zero_on_cpu():
    ops.reset_launch_counts()
    pool = torch.zeros((1, 4, 8, 2, 32))
    ops.page_gather(pool, torch.tensor([1], dtype=torch.int32))
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    assert all(n == 0 for n in ops.launch_counts().values())
