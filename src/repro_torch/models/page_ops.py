"""Paged-pool operations of one attention layer, over the step's page tables.

:class:`PageCtx` carries the device-side addressing of one engine step;
:func:`paged_attn_op` writes a decode token's K/V into the pools and runs
the paged decode-attention kernel (or the fused gather-attend kernel when
the step carries staged pages); :func:`prefill_write_op` scatters a
prefill's K/V into the pools.  GQA layers (:mod:`repro_torch.models.
transformer`, :mod:`repro_torch.models.hybrid`) and MLA layers
(:mod:`repro_torch.models.mla`, over the latent pools) share them.  The
plain writers live in :mod:`repro_torch.models.paged`, which the kernels'
plain versions import, so these ops sit a module above it.

Over a mesh (a :class:`~repro_torch.models.common.ParallelCtx` with page
shards, the reference's ``shard_map`` branches) each rank holds the pages
of its stripe of frames in its own pool and reads its own column of the
tables: it writes a decode token only where its ``wpage`` column holds the
write page (the other ranks' columns are -1), runs the paged kernel over
its pages for every query head, and the (o, m, l) partials are
flash-combined across the page group; a prefill writes the pages of its
stripe.  The context's batch rows are this rank's rows (the caller slices
them, :meth:`PageCtx.rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.paged_attention import (
    fused_paged_attention_kernel,
    paged_attention_kernel,
)
from repro_torch.models import paged
from repro_torch.models.common import ParallelCtx


@dataclasses.dataclass
class PageCtx:
    """Device-side paged-KV addressing for one engine step.

    tables/ntok: [B, S, mpps]; wpage: [B, S]; wslot: [B] (int32 tensors).

    Fused fault-in decode adds ``slots`` [B, S, mpps] (staging slot of each
    page, -1 = read the pool) and the step's staged pages ``stage_k`` /
    ``stage_v``, layer-stacked [L, NS, ptok, n_kv, dh]; each layer's
    attention reads its own slice.
    """

    tables: torch.Tensor
    ntok: torch.Tensor
    wpage: torch.Tensor
    wslot: torch.Tensor
    frame_pages: int = 16       # frame striping granularity (prefill scatter)
    slots: Optional[torch.Tensor] = None
    stage_k: Optional[torch.Tensor] = None
    stage_v: Optional[torch.Tensor] = None

    def rows(self, par: Optional[ParallelCtx]) -> "PageCtx":
        """This context at ``par``'s rows of the batch (itself when the
        batch is not split)."""
        if par is None or not par.batch_sharded or par.dp_size == 1:
            return self
        return dataclasses.replace(
            self, tables=par.rows(self.tables), ntok=par.rows(self.ntok),
            wpage=par.rows(self.wpage), wslot=par.rows(self.wslot),
            slots=None if self.slots is None else par.rows(self.slots))

    def stage_at(self, i) -> "PageCtx":
        """This context with the staged pages of layer ``i`` (an index or
        a slice of the stack); itself when the step stages nothing."""
        if self.stage_k is None:
            return self
        return dataclasses.replace(self, stage_k=self.stage_k[i],
                                   stage_v=self.stage_v[i])


def _stripe(par: Optional[ParallelCtx], ctx: PageCtx):
    """(page rank, page shards) of ``par``, checked against the tables'
    shard dim; (0, 1) without page shards."""
    if par is None or par.page_shards == 1:
        return 0, 1
    if ctx.tables.shape[1] != par.page_shards:
        raise ValueError(f"tables stripe over {ctx.tables.shape[1]} shards, "
                         f"the page group over {par.page_shards}")
    return par.page_rank, par.page_shards


def paged_attn_op(q, k_new, v_new, k_pool, v_pool, ctx: PageCtx, *, scale,
                  par: Optional[ParallelCtx] = None):
    """Decode pool write + paged attention (pools updated in place).

    q [B,H,dh]; k_new [B,n_kv,dh], v_new [B,n_kv,dh_v]; pools [NP, ptok,
    n_kv, dh] and [NP, ptok, n_kv, dh_v] (MLA: the latent pools, dh_v <
    dh).  Returns o [B,H,dh_v] in q's dtype.  With ``par``'s page shards
    the pools are this rank's, its table column is read and the partials
    are combined across the page group (q, k_new and v_new: every head of
    this rank's rows).
    """
    B = q.shape[0]
    shard, n_shards = _stripe(par, ctx)
    if n_shards > 1:
        if ctx.slots is not None:
            # Staged pages are an engine-local (mesh-free) decode path; the
            # sharded path would need staging sub-pools per page shard.
            raise NotImplementedError(
                "fused staging decode (PageCtx.slots) has no mesh path")
        tables = ctx.tables[:, shard].contiguous()
        ntok = ctx.ntok[:, shard].contiguous()
        wpage = ctx.wpage[:, shard]
    else:
        tables = ctx.tables.reshape(B, -1)
        ntok = ctx.ntok.reshape(B, -1)
        # One shard column holds the write page; the rest are -1.
        wpage = ctx.wpage.reshape(B, -1).amax(dim=1)
    paged.write_kv(k_pool, v_pool, k_new, v_new, wpage, ctx.wslot)
    if ctx.slots is not None:
        o, m, l = fused_paged_attention_kernel(
            q, k_pool, v_pool, ctx.stage_k, ctx.stage_v, tables,
            ctx.slots.reshape(B, -1), ntok, scale=scale)
    else:
        o, m, l = paged_attention_kernel(q, k_pool, v_pool, tables, ntok,
                                         granularity="page", scale=scale)
    group = par.page_group if n_shards > 1 else None
    return paged.combine_partials(o, m, l, group).to(q.dtype)


def prefill_write_op(k_seq, v_seq, k_pool, v_pool, ctx: PageCtx,
                     tok_offset: int = 0, par: Optional[ParallelCtx] = None):
    """Scatter prefilled K/V [B,T,n_kv,dh] into the paged pool, in place;
    with ``par``'s page shards the pages of this rank's stripe into its
    pool (its table column, local page j backing the global page that
    :func:`~repro_torch.models.paged.write_prefill_kv` reconstructs)."""
    shard, n_shards = _stripe(par, ctx)
    tables = (ctx.tables[:, shard] if n_shards > 1
              else ctx.tables.reshape(ctx.tables.shape[0], -1))
    return paged.write_prefill_kv(k_pool, v_pool, k_seq, v_seq, tables,
                                  shard_idx=shard, n_shards=n_shards,
                                  frame_pages=ctx.frame_pages,
                                  tok_offset=tok_offset)
