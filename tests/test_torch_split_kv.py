"""Split-KV paged attention: what the CPU can check of the card's kernel.

The kernel (``csrc/paged_attention.cu``) cannot run here; these tests pin
its wrapper's split arithmetic to the source, the layout-variant tool's
edits to the source, and, in plain PyTorch, the algorithm the kernel runs:
per-span (o, m, l) partials over table token positions, folded with a
global max first and sums in split order, equal the unsplit plain version,
and splits without valid tokens are exact no-ops (so a row's result does
not depend on the table's width).  The card-only tests in
``tests/test_torch_cuda.py`` hold the kernel itself to the same.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import paged_variants
from repro_torch.models.layers import NEG_INF

SOURCE = (build.CSRC / "paged_attention.cu").read_text()


def _constant(name, src=SOURCE):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_split_tokens_match_the_kernel_source():
    assert pa.SPLIT_TOKENS == _constant("kSpan")
    assert _constant("kSpan") % _constant("kChunk") == 0


@pytest.mark.parametrize("n_blocks,tpb", [(32, 64), (2, 1024), (3, 8),
                                          (0, 64), (1, 1)])
def test_split_count_covers_the_table(n_blocks, tpb):
    n = pa.split_count(n_blocks, tpb)
    assert n * pa.SPLIT_TOKENS >= n_blocks * tpb
    assert (n - 1) * pa.SPLIT_TOKENS < n_blocks * tpb or n == 0


@pytest.mark.parametrize("name", list(paged_variants.VARIANTS))
def test_variant_tool_edits_each_layout_constant(name):
    src = paged_variants.variant_source(SOURCE,
                                        *paged_variants.VARIANTS[name])
    got = tuple(_constant(c, src) for c in ("kSpan", "kChunk", "kWarps",
                                            "HB"))
    assert got == paged_variants.VARIANTS[name]


def _split_partials(q, pool_k, pool_v, tables, ntok, scale, span):
    """Plain per-span partials: (o [B,H,S,dh], m [B,H,S], l [B,H,S])."""
    B, H, dh = q.shape
    _np, ptok, n_kv, _ = pool_k.shape
    g = H // n_kv
    n_pos = tables.shape[1] * ptok
    S = -(-n_pos // span)
    o = torch.zeros(B, H, S, dh)
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros(B, H, S)
    for b in range(B):
        for s in range(S):
            rows = []
            for p in range(s * span, min((s + 1) * span, n_pos)):
                blk, t = divmod(p, ptok)
                if tables[b, blk] >= 0 and t < ntok[b, blk]:
                    rows.append((int(tables[b, blk]), t))
            if not rows:
                continue
            k = torch.stack([pool_k[e, t] for e, t in rows]).float()
            v = torch.stack([pool_v[e, t] for e, t in rows]).float()
            for h in range(H):
                sc = (q[b, h].float() * scale) @ k[:, h // g].T
                m[b, h, s] = sc.max()
                p_ = torch.exp(sc - m[b, h, s])
                l[b, h, s] = p_.sum()
                o[b, h, s] = p_ @ v[:, h // g]
    return o, m, l


def _combine(o, m, l):
    """The combine launch: global max first, then sums in split order."""
    M = m.max(dim=-1).values if m.shape[-1] else torch.full(m.shape[:-1],
                                                            NEG_INF)
    w = torch.exp(m - M[..., None])
    oo, ll = torch.zeros(o.shape[:2] + o.shape[3:]), torch.zeros(m.shape[:2])
    for s in range(m.shape[-1]):
        oo = oo + o[:, :, s] * w[..., s, None]
        ll = ll + l[..., s] * w[..., s]
    return oo, M, ll


@pytest.mark.parametrize("span", [64, 32])
def test_split_combine_equals_the_plain_version(span):
    rng = np.random.default_rng(3)
    B, H, n_kv, dh, ptok, n_blocks, NP = 3, 4, 2, 16, 16, 10, 24
    pool_k, pool_v = (torch.from_numpy(rng.normal(size=(
        NP, ptok, n_kv, dh)).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(B, H, dh)).astype(np.float32))
    tables = np.full((B, n_blocks), -1, np.int32)
    ntok = np.zeros((B, n_blocks), np.int32)
    tables[0, :7], ntok[0, :7] = np.arange(7), ptok      # several splits
    ntok[0, 6] = 5                                       # partial last one
    tables[1, [0, 5, 6]] = [9, 10, 11]                   # a hole split
    ntok[1, [0, 5, 6]] = [ptok, ptok, 3]
    # row 2: only holes
    tables, ntok = torch.from_numpy(tables), torch.from_numpy(ntok)
    scale = dh ** -0.5
    parts = _split_partials(q, pool_k, pool_v, tables, ntok, scale, span)
    o, m, l = _combine(*parts)
    o_r, m_r, l_r = ref.paged_attention_ref(q, pool_k, pool_v, tables, ntok,
                                            scale=scale)
    torch.testing.assert_close(o[:2] / l[:2, :, None],
                               o_r[:2] / l_r[:2, :, None], rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(m, m_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_r, rtol=1e-5, atol=1e-5)
    assert (m[2] == NEG_INF).all() and (l[2] == 0).all() and \
        (o[2] == 0).all()
    # Trailing splits of holes (a wider table) change no bit.
    wide = [torch.cat([x, torch.full_like(x[:, :, :3], fill)], dim=2)
            for x, fill in zip(parts, (0.0, NEG_INF, 0.0))]
    for a, b in zip(_combine(*wide), (o, m, l)):
        assert torch.equal(a, b)
