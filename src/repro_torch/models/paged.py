"""Paged KV-cache: the model-side consumer of Mosaic page tables.

Counterpart of the reference's ``models/paged.py``: the writers, the
plain partial attention and :func:`combine_partials`, whose combine across
page shards runs over a process group (the reference's ``pmax`` / ``psum``
over mesh axes).

Layout (per layer):
  k_pool / v_pool : [num_pages, page_tokens, n_kv, head_dim]

Device-side state is addressed through packed tables prepared by
:class:`repro_torch.serving.kv_cache.ShardedKVCache`:

  tables  : int32 [B, mpps]  page id (-1 = hole)
  ntok    : int32 [B, mpps]  valid tokens in that page
  wpage   : int32 [B]        page holding the current write slot (-1: none)
  wslot   : int32 [B]        slot within the write page

Unlike the reference, whose arrays are immutable, the writers here update
the pools **in place** and return them.  :func:`paged_attention_local` is
the plain PyTorch version of the paged decode-attention kernel; the kernel
itself is :mod:`repro_torch.kernels.paged_attention`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

NEG_INF = -1e30


def write_kv(k_pool, v_pool, k_new, v_new, wpage, wslot):
    """Write one new token's K/V per row into the pools, in place.

    k_new/v_new: [B, n_kv, dh]; wpage: [B] page id (-1: not owned here, the
    row is dropped); wslot: [B].  Returns the (updated) pools.

    A dropped row is never clamped onto page 0, a live page: it re-writes
    the first kept row's own payload to the same slot instead (or page 0's
    slot with its current bytes when no row is kept), so every duplicate
    destination receives identical bytes and the write order cannot matter.
    Keeps the write free of host synchronisation.
    """
    ptok = k_pool.shape[1]
    keep = wpage >= 0
    # index_select with a device index: indexing with a 0-d tensor would
    # copy it to the host (a synchronisation per layer).
    first = torch.argmax(keep.to(torch.int32)).view(1)
    any_keep = keep.any()
    rows = wpage.long() * ptok + wslot.long()
    rows = torch.where(keep, rows,
                       torch.where(any_keep, rows.index_select(0, first), 0))

    def upd(pool, new):
        flat = pool.view(pool.shape[0] * ptok, *pool.shape[2:])
        new = new.to(pool.dtype)
        sel = keep.view(-1, *([1] * (new.dim() - 1)))
        fill = torch.where(any_keep, new.index_select(0, first), flat[:1])
        flat[rows] = torch.where(sel, new, fill)
        return pool

    return upd(k_pool, k_new), upd(v_pool, v_new)


def write_prefill_kv(k_pool, v_pool, k_seq, v_seq, tables, *,
                     shard_idx: int = 0, n_shards: int = 1,
                     frame_pages: int = 16, tok_offset: int = 0):
    """Scatter a prefilled sequence's KV into the pools en masse, in place.

    k_seq/v_seq: [B, T, n_kv, dh] (T multiple of page_tokens);
    tables: [B, mpps] page ids owned by this shard in local vpn order (-1
    holes).  Pages stripe over shards by frame round-robin, so local page j
    of shard s backs global vpn

        ((s + (j // frame_pages) * n_shards) * frame_pages + j % frame_pages)

    With n_shards == 1 this is vpn == j.  ``tok_offset`` (a page multiple)
    shifts the window for suffix-only prefill: only pages fully inside
    ``[tok_offset, tok_offset + T)`` are written.  Holes are dropped, never
    clamped onto a live page.
    """
    B, T, n_kv, dh = k_seq.shape
    ptok = k_pool.shape[1]
    assert T % ptok == 0
    assert tok_offset % ptok == 0, (tok_offset, ptok)
    dev = k_pool.device
    m = tables.shape[1]
    j = torch.arange(m, device=dev)
    gframe = shard_idx + (j // frame_pages) * n_shards
    vpn = gframe * frame_pages + (j % frame_pages)
    tok0 = vpn * ptok
    tb = tables.reshape(-1).long()
    own = (tb >= 0) & ((tok0 >= tok_offset)
                       & (tok0 < tok_offset + T)).repeat(B)
    idx = (tok0[:, None] - tok_offset
           + torch.arange(ptok, device=dev)[None, :]).clamp(0, T - 1)
    target = tb[own]

    def upd(pool, seq):
        new = seq[:, idx].reshape(B * m, ptok, n_kv, seq.shape[-1])
        pool[target] = new[own].to(pool.dtype)
        return pool

    return upd(k_pool, k_seq), upd(v_pool, v_seq)


def paged_attention_local(
    q, k_pool, v_pool, tables, ntok, *, scale: Optional[float] = None,
    page_block: int = 8, stage_k=None, stage_v=None, slots=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial paged attention over a set of pages (plain version).

    q:      [B, H, dh] single decode query per sequence
    tables: [B, mpps] page ids; ntok: [B, mpps] valid tokens/page
    Returns unnormalized (o [B,H,dh_v], m [B,H], l [B,H]) fp32 partials.

    ``stage_k``/``stage_v`` [NS, ptok, n_kv, dh] + ``slots`` [B, mpps]
    read partially-resident KV: a page whose slot is >= 0 is loaded from
    the staging pool at that slot instead of the pool.  Only the load
    source changes, never the accumulation order, so with staged bytes
    equal to the pool's the result is bitwise the slot-free call's, and
    ``slots=None`` is the all-resident path byte for byte.
    """
    B, H, dh = q.shape
    _np, ptok, n_kv, _ = k_pool.shape
    dh_v = v_pool.shape[-1]
    mpps = tables.shape[1]
    groups = H // n_kv
    scale = scale if scale is not None else dh ** -0.5
    dev = q.device
    pb = min(page_block, mpps)
    pad = (-mpps) % pb
    if pad:
        tables = F.pad(tables, (0, pad), value=-1)
        ntok = F.pad(ntok, (0, pad))
        if slots is not None:
            slots = F.pad(slots, (0, pad), value=-1)
        mpps += pad
    # An empty stage (NS = 0) can only come with every slot -1.
    staged = slots is not None and stage_k.shape[0] > 0
    qg = (q.float() * scale).reshape(B, n_kv, groups, dh)
    m = torch.full((B, n_kv, groups), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, n_kv, groups), dtype=torch.float32, device=dev)
    o = torch.zeros((B, n_kv, groups, dh_v), dtype=torch.float32, device=dev)
    slot = torch.arange(ptok, device=dev)[None, None, :]
    for blk in range(mpps // pb):
        tb = tables[:, blk * pb:(blk + 1) * pb]
        nt = ntok[:, blk * pb:(blk + 1) * pb]
        safe = tb.clamp(min=0).long()
        k, v = k_pool[safe], v_pool[safe]        # [B, pb, ptok, n_kv, dh]
        if staged:
            sl = slots[:, blk * pb:(blk + 1) * pb]
            sel = (sl >= 0)[..., None, None, None]
            ssafe = sl.clamp(min=0).long()
            k = torch.where(sel, stage_k[ssafe], k)
            v = torch.where(sel, stage_v[ssafe], v)
        k = k.reshape(B, pb * ptok, n_kv, dh).float()
        v = v.reshape(B, pb * ptok, n_kv, dh_v).float()
        # Grouped GQA scores without materializing repeated K/V.
        s = torch.einsum("bngd,bknd->bngk", qg, k)
        valid = (tb >= 0)[:, :, None] & (slot < nt[:, :, None])
        valid = valid.reshape(B, 1, 1, pb * ptok)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bngk,bknd->bngd", p, v)
        m = m_new
    return o.reshape(B, H, dh_v), m.reshape(B, H), l.reshape(B, H)


def combine_partials(o, m, l, group=None):
    """Flash-combine the (o, m, l) partials of the ranks of ``group`` (the
    page shards a sequence stripes over) and normalise: the reference's
    ``combine_partials`` over mesh axes.  m takes a MAX all-reduce; l and o,
    each rescaled by exp(m - m_g), one packed SUM all-reduce.  A rank
    without valid tokens for a row holds m = -1e30, l = 0, o = 0 and adds
    exact zeros.  ``group`` None: this rank's partials are the whole."""
    if group is not None:
        m_g = m.contiguous().clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - m_g)
        packed = torch.cat([(l * corr)[..., None], o * corr[..., None]],
                           dim=-1).contiguous()
        dist.all_reduce(packed, group=group)
        l, o = packed[..., 0], packed[..., 1:]
    return o / torch.clamp(l[..., None], min=1e-30)
