"""Plain PyTorch versions of every CUDA kernel in this package.

Counterpart of the reference's ``kernels/ref.py``.  The kernel wrappers run
these only for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.  Page-movement versions take layer-stacked pools
``[L, NP, ...]`` like the kernels (pass ``pool[None]`` for one layer) and,
like the kernels, update pools in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import NEG_INF, attention
from repro_torch.models.paged import combine_partials, paged_attention_local


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                        scale=None):
    """Prefill attention of queries at positions ``q_offset ..`` over
    [B, Tk, n_kv, dh] keys: the blockwise online-softmax loop of
    :func:`repro_torch.models.layers.attention`."""
    return attention(q, k, v, causal=causal, q_offset=q_offset,
                     kv_len=kv_len, scale=scale)


def flash_attention_lse_ref(q, k, v, *, causal=True, scale=None):
    """The training forward: :func:`flash_attention_ref`'s output and each
    row's log-sum-exp of its scaled scores, ``m + log l``, f32 [B, H, Tq]."""
    return attention(q, k, v, causal=causal, scale=scale, return_lse=True)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, scale=None):
    """Gradients (dq, dk, dv) of the attention of q [B, Tq, H, dh] over k
    [B, Tk, n_kv, dh] and v [B, Tk, n_kv, dh_v] given o and dO = ``do``
    [B, Tq, H, dh_v] (dh_v = dh, or MLA's narrower values), written out as
    the backward kernel computes them, in f32:

        D  = rowsum(dO ∘ O)
        P  = exp(scale·Q Kᵀ − lse)   (exact zeros where the forward masks)
        dV = Σ Pᵀ dO        dS = P ∘ (dO Vᵀ − D)
        dQ = scale · dS K   dK = scale · dSᵀ Q

    with dK and dV summed over the g = H / n_kv query heads of each KV
    head.  Queries sit at positions 0 .. Tq - 1 (causal: key j is seen by
    row i when j <= i).  Returned in the inputs' dtypes."""
    B, Tq, H, dh = q.shape
    Tk, n_kv = k.shape[1:3]
    g = H // n_kv
    scale = dh ** -0.5 if scale is None else scale

    def grouped(t):          # [B, T, H, d] -> [B, n_kv, g, T, d] f32
        return t.float().reshape(B, t.shape[1], n_kv, g, -1).permute(
            0, 2, 3, 1, 4)

    qf, of, dof = grouped(q), grouped(o), grouped(do)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    D = (dof * of).sum(-1)                                # [B, n, g, Tq]
    s = torch.einsum("bngqd,bnkd->bngqk", qf, kf) * scale
    if causal:
        mask = torch.arange(Tk, device=q.device)[None, :] \
            <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, n_kv, g, Tq, 1))
    if causal:
        p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bngqk,bngqd->bnkd", p, dof)
    ds = p * (torch.einsum("bngqd,bnkd->bngqk", dof, vf) - D[..., None])
    dq = torch.einsum("bngqk,bnkd->bngqd", ds, kf) * scale
    dk = torch.einsum("bngqk,bngqd->bnkd", ds, qf) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, dh)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


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


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Mamba-2 SSD chunked scan: the reference's ``ssd_chunked`` oracle.

    x [B, T, nh, hd]; dt [B, T, nh] f32 (post-softplus); A [nh] f32
    (negative); Bm / Cm [B, T, G, N] with G dividing nh (head h reads group
    h // (nh // G); G = nh is the head-expanded form); h0 [B, nh, hd, N]
    f32 or None; T a multiple of ``chunk``.  The groups are repeated to
    every head first, so a grouped call is bitwise its head-expanded call.
    Per chunk: the intra-chunk term (scores C B^T masked *before* exp of
    the cumulative-decay segments), the chunk-final states, and the
    inter-chunk recurrence as a loop over chunks.  Returns
    (y [B, T, nh, hd] f32, h_final [B, nh, hd, N] f32).
    """
    Bsz, T, nh, hd = x.shape
    N = Bm.shape[-1]
    G = Bm.shape[2]
    if G < 1 or nh % G:
        raise ValueError(f"{G} B/C groups do not divide {nh} heads")
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    if G != nh:
        Bm = torch.repeat_interleave(Bm, nh // G, dim=2)
        Cm = torch.repeat_interleave(Cm, nh // G, dim=2)
    nc = T // chunk

    def r(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])

    xc, dtc, Bc, Cc = r(x), r(dt.float()), r(Bm).float(), r(Cm).float()
    xdt = xc.float() * dtc[..., None]                 # dt-weighted input
    cum = torch.cumsum(dtc * A.float(), dim=2)        # [B, nc, Q, nh]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,Q,Q,nh]
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # Mask before exp: exp of a masked (i < j) positive segment overflows.
    ldec = torch.exp(torch.where(causal, seg, NEG_INF))
    scores = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc) * ldec
    y_diag = torch.einsum("bclsh,bcshp->bclhp", scores, xdt)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # [B, nc, Q, nh]
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", Bc, decay_states, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [B, nc, nh]
    h = (torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                    # [B,nc,nh,hd,N]
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, h_prev,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(Bsz, T, nh, hd), h


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh=None, *, chunk: int, h0=None):
    """Gradients of :func:`ssd_scan_ref`'s (y, h_final) given dy [B, T, nh,
    hd] and dh [B, nh, hd, N] (None: zero), as the reference takes them:
    the vector-Jacobian product of the chunked scan through autograd
    (``jax.value_and_grad`` of ``ssd_chunked``, ``repro/models/mamba2.py``).
    Returns (dx, d dt, dA, dB, dC, dh0) in the inputs' dtypes, dB / dC over
    the [B, T, G, N] groups (summed over each group's heads); dh0 is None
    without h0."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, dt, A, Bm, Cm) + ((h0,) if h0 is not None
                                                 else ())]
        y, h = ssd_scan_ref(*leaves[:5], chunk=chunk,
                            h0=leaves[5] if h0 is not None else None)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h)
            grads.append(dh)
        got = torch.autograd.grad(outs, leaves, grads, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(leaves, got)]
    return (*got[:5], got[5] if h0 is not None else None)
