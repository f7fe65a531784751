"""Plain PyTorch versions of every CUDA kernel in this package.

Counterpart of the reference's ``kernels/ref.py``.  The kernel wrappers run
these only for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.  Page-movement versions take layer-stacked pools
``[L, NP, ...]`` like the kernels (pass ``pool[None]`` for one layer) and,
like the kernels, update pools in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.paged import combine_partials, paged_attention_local


def frames_to_pages(tables, ntok, *, frame_pages: int, page_tokens: int):
    """Expand frame tables [B, nf] into their pages' tables [B, nf·fp]."""
    B, nf = tables.shape
    fp = frame_pages
    offs = torch.arange(fp, device=tables.device, dtype=tables.dtype)
    pages = tables[..., None] * fp + offs[None, None, :]
    pages = torch.where(tables[..., None] >= 0, pages, -1).reshape(B, nf * fp)
    slot0 = offs[None, None, :] * page_tokens
    ntok_pages = (ntok[..., None] - slot0).clamp(0, page_tokens)
    return pages, ntok_pages.reshape(B, nf * fp)


def paged_attention_ref(q, pool_k, pool_v, tables, ntok, *, scale,
                        frame_pages: int = 1):
    """Unnormalized (o, m, l) over the blocks named by ``tables``: pages, or
    with ``frame_pages > 1`` aligned frames (a frame is its pages)."""
    if frame_pages > 1:
        tables, ntok = frames_to_pages(tables, ntok, frame_pages=frame_pages,
                                       page_tokens=pool_k.shape[1])
    return paged_attention_local(q, pool_k, pool_v, tables, ntok, scale=scale)


def fused_paged_attention_ref(q, pool_k, pool_v, stage_k, stage_v, tables,
                              slots, ntok, *, scale):
    """Unnormalized (o, m, l) over page tables where page ``blk`` of row
    ``b`` is read from ``stage[slots[b, blk]]`` when that slot is >= 0 and
    from ``pool[tables[b, blk]]`` otherwise; one accumulator in table
    order, so every slot -1 gives :func:`paged_attention_ref` bitwise."""
    return paged_attention_local(q, pool_k, pool_v, tables, ntok, scale=scale,
                                 stage_k=stage_k, stage_v=stage_v,
                                 slots=slots)


def paged_attention_full_ref(q, pool_k, pool_v, tables, ntok, *, scale):
    """Normalized single-shard paged attention over page tables."""
    o, m, l = paged_attention_local(q, pool_k, pool_v, tables, ntok,
                                    scale=scale)
    return combine_partials(o, m, l)


def page_gather_ref(pool, idx):
    """pages[l, i] = pool[l, idx[i]]; holes (idx < 0) return page 0."""
    return pool[:, idx.clamp(min=0).long()]


def page_scatter_ref(pool, idx, pages):
    """pool[l, idx[i]] = pages[l, i] in place; holes (idx < 0) are no-ops."""
    keep = idx >= 0
    pool[:, idx[keep].long()] = pages[:, keep].to(pool.dtype)
    return pool


def page_compact_ref(pool, src, dst):
    """pool[l, dst[i]] = pool[l, src[i]] in place; entries with src or
    dst < 0 are no-ops."""
    keep = (src >= 0) & (dst >= 0)
    moved = pool[:, src[keep].long()]
    pool[:, dst[keep].long()] = moved
    return pool
