"""Paged decode attention, both granularities: wrapper of ``csrc/paged_attention.cu``.

Replaces the reference's Pallas ``paged_attention_kernel``
(``repro/kernels/paged_attention.py``).  ``granularity="page"`` walks one
base page per table entry (the splintered path); ``"frame"`` walks one
coalesced, aligned frame of ``frame_pages`` pages per entry (the paper's
large-page fast path: one table lookup per frame).  Both return
unnormalized fp32 ``(o, m, l)`` partials that :func:`combine_granularities`
flash-combines.

:func:`fused_paged_attention_kernel` replaces the reference's Pallas
``fused_paged_attention_kernel``: the page kernel over partially-resident
KV, reading each page whose staging slot is >= 0 from the staging pool
(the fused fault-in decode of ``ServingEngine(fault_mode="fused")``).

Values may be narrower than keys: MLA's absorbed decode reads a K pool of
latent + rope = 576 and a V pool of the 512-wide latent, with all 16 query
heads on its one KV head; that shape runs a tensor-core partials kernel of
its own (bf16 only), with the same spans, scratch and combine.  The fused
kernel takes equal widths only.

On the card each call is two launches of one source: partials over fixed
spans of ``SPLIT_TOKENS`` table token positions (split-KV), then their
combine in split order; the scratch between them is allocated here.  The
split depends only on a row's table token positions, so a row's result is
the same bits in any batch and at any page ids.

For CPU tensors the wrappers run the plain versions
(:func:`repro_torch.kernels.ref.paged_attention_ref`,
:func:`~repro_torch.kernels.ref.fused_paged_attention_ref`); for CUDA
tensors they launch the kernel or raise.  ``paged_attention_kernel.
page_launches`` / ``.frame_launches`` and ``fused_paged_attention_kernel.
fused_launches`` count wrapper calls that launched (partials and combine
together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = tuple(range(32, 257, 32))   # key = value widths, any dtype
MLA_DIMS = (576, 512)   # (key, value) widths of MLA's latent pools, bf16
SPLIT_TOKENS = 64       # table token positions per split (csrc kSpan)


def split_count(n_blocks: int, tokens_per_block: int) -> int:
    """Splits the partials launch walks for a table of ``n_blocks`` blocks."""
    return -(-n_blocks * tokens_per_block // SPLIT_TOKENS)


def _query(q):
    """q as the kernels read it: contiguous bf16 or f32."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        q = q.float()
    return q.contiguous()


def _scratch(q, n_blocks: int, tokens_per_block: int, dh_v: int):
    """f32 scratch for the partials: (o, m, l) of every (row, head, split)."""
    B, H, _dh = q.shape
    n = B * H * split_count(n_blocks, tokens_per_block) * (dh_v + 2)
    return torch.empty(n, dtype=torch.float32, device=q.device)


def paged_attention_kernel(q, pool_k, pool_v, tables, ntok, *,
                           granularity: str, frame_pages: int = 16,
                           scale: float = 1.0):
    """q [B, H, dh]; pool_k [NP, ptok, n_kv, dh], pool_v [NP, ptok, n_kv,
    dh_v] (bf16 or f32; MLA's dh 576 / dh_v 512 bf16 only); tables/ntok
    int32 [B, n_blocks] (page or frame ids, -1 holes; valid tokens per
    block).  Returns (o [B,H,dh_v] f32, m [B,H] f32, l [B,H] f32).
    """
    if granularity not in ("page", "frame"):
        raise ValueError(f"granularity must be 'page' or 'frame', "
                         f"got {granularity!r}")
    fp = frame_pages if granularity == "frame" else 1
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool_k, pool_v, tables, ntok,
                                       scale=scale, frame_pages=fp)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention path for device {q.device}")
    _check_inputs(q, pool_k, pool_v, tables, ntok, fp)
    B, H, dh = q.shape
    ptok, n_kv = pool_k.shape[1:3]
    dh_v = pool_v.shape[-1]
    qk = _query(q)
    o = torch.empty((B, H, dh_v), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, m, l
    lib = _lib()
    scratch = _scratch(q, tables.shape[1], fp * ptok, dh_v)
    err = lib.paged_attention_fwd(
        qk.data_ptr(), int(qk.dtype == torch.float32), pool_k.data_ptr(),
        pool_v.data_ptr(), tables.data_ptr(), ntok.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), scratch.data_ptr(), B, H, n_kv, dh, dh_v,
        tables.shape[1], fp * ptok, int(pool_k.dtype == torch.float32),
        float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "paged_attention_fwd")
    if granularity == "page":
        paged_attention_kernel.page_launches += 1
    else:
        paged_attention_kernel.frame_launches += 1
    return o, m, l


paged_attention_kernel.page_launches = 0
paged_attention_kernel.frame_launches = 0


def _check_inputs(q, pool_k, pool_v, tables, ntok, fp: int, *,
                  fused: bool = False) -> None:
    """Raise on what the kernels do not take (device, dtype, shape,
    contiguity, alignment)."""
    B, H, dh = q.shape
    NP, _ptok, n_kv, dh_k = pool_k.shape
    dh_v = pool_v.shape[-1]
    if pool_v.shape[:3] != pool_k.shape[:3] or dh_k != dh:
        raise ValueError(f"pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (dh, dh_v) == MLA_DIMS and not fused:
        if q.dtype != torch.bfloat16 or pool_k.dtype != torch.bfloat16:
            raise ValueError(f"the {dh} / {dh_v} (MLA) path takes bf16 q "
                             f"and pools, got {q.dtype} / {pool_k.dtype}")
    elif dh_v != dh:
        raise ValueError(f"value head dim {dh_v} != key head dim {dh}: only "
                         f"{MLA_DIMS[0]} / {MLA_DIMS[1]} (MLA, page and "
                         f"frame) is ported")
    elif dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} unsupported: multiples of 32 up "
                         f"to 256, or {MLA_DIMS[0]} / {MLA_DIMS[1]}")
    if H % n_kv:
        raise ValueError(f"{H} query heads do not group over {n_kv} KV heads")
    if NP % fp:
        raise ValueError(f"{NP} pool pages are not whole {fp}-page frames")
    if pool_k.dtype not in (torch.bfloat16, torch.float32) \
            or pool_v.dtype != pool_k.dtype:
        raise ValueError(f"pool dtype {pool_k.dtype} unsupported "
                         f"(bfloat16 or float32)")
    if tables.shape != ntok.shape or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} / ntok "
                         f"{tuple(ntok.shape)} do not match batch {B}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("tables", tables), ("ntok", ntok)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("tables", tables), ("ntok", ntok)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def fused_paged_attention_kernel(q, pool_k, pool_v, stage_k, stage_v, tables,
                                 slots, ntok, *, scale: float = 1.0):
    """Page-granularity paged attention over partially-resident KV.

    As :func:`paged_attention_kernel` with ``granularity="page"``, plus
    stage_k/v [NS, ptok, n_kv, dh] in the pools' dtype (NS may be 0) and
    slots int32 [B, n_blocks]: page ``blk`` of row ``b`` is read from
    ``stage[slots[b, blk]]`` when that slot is >= 0, else from the pool.
    Returns (o [B,H,dh] f32, m [B,H] f32, l [B,H] f32).
    """
    if q.device.type == "cpu":
        return ref.fused_paged_attention_ref(q, pool_k, pool_v, stage_k,
                                             stage_v, tables, slots, ntok,
                                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention path for device {q.device}")
    _check_inputs(q, pool_k, pool_v, tables, ntok, 1, fused=True)
    NS = stage_k.shape[0]
    if stage_v.shape != stage_k.shape \
            or tuple(stage_k.shape[1:]) != tuple(pool_k.shape[1:]):
        raise ValueError(f"stages {tuple(stage_k.shape)} / "
                         f"{tuple(stage_v.shape)} do not match pool pages "
                         f"{tuple(pool_k.shape[1:])}")
    for name, t in (("stage_k", stage_k), ("stage_v", stage_v)):
        if t.dtype != pool_k.dtype:
            raise ValueError(f"{name} is {t.dtype}, the pools {pool_k.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if NS and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if slots.shape != tables.shape or slots.dtype != torch.int32:
        raise ValueError(f"slots must be int32 {tuple(tables.shape)}, got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if slots.device != q.device or not slots.is_contiguous():
        raise ValueError("slots must be contiguous and on q's device")
    if not torch.cuda.is_current_stream_capturing():
        # One host synchronisation to read the slot range back; a CUDA
        # graph capture cannot synchronise, so it trusts its inputs.
        top = int(slots.max()) if slots.numel() else -1
        if top >= NS:
            raise ValueError(f"slot {top} out of range for {NS} staged "
                             f"pages")
    B, H, dh = q.shape
    ptok, n_kv = pool_k.shape[1:3]
    qk = _query(q)
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, m, l
    lib = _lib()
    scratch = _scratch(q, tables.shape[1], ptok, dh)
    err = lib.fused_paged_attention_fwd(
        qk.data_ptr(), int(qk.dtype == torch.float32), pool_k.data_ptr(),
        pool_v.data_ptr(), stage_k.data_ptr() if NS else None,
        stage_v.data_ptr() if NS else None, tables.data_ptr(),
        slots.data_ptr(), ntok.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), scratch.data_ptr(), B, H, n_kv, dh, tables.shape[1],
        ptok, int(pool_k.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "fused_paged_attention_fwd")
    fused_paged_attention_kernel.fused_launches += 1
    return o, m, l


fused_paged_attention_kernel.fused_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_fwd.argtypes = [P, I, P, P, P, P, P, P, P, P, I, I,
                                        I, I, I, I, I, I, ctypes.c_float, P]
    lib.paged_attention_fwd.restype = I
    lib.fused_paged_attention_fwd.argtypes = [P, I, P, P, P, P, P, P, P, P,
                                              P, P, P, I, I, I, I, I, I, I,
                                              ctypes.c_float, P]
    lib.fused_paged_attention_fwd.restype = I
    lib.paged_attention_split_tokens.restype = I
    if lib.paged_attention_split_tokens() != SPLIT_TOKENS:
        raise RuntimeError("csrc/paged_attention.cu splits at "
                           f"{lib.paged_attention_split_tokens()} tokens, "
                           f"the wrapper at {SPLIT_TOKENS}")
    return lib


def combine_granularities(parts):
    """Flash-combine [(o, m, l), ...] partials from both granularities."""
    os_, ms, ls = zip(*parts)
    m_g = functools.reduce(torch.maximum, ms)
    l_g = sum(l * torch.exp(m - m_g) for m, l in zip(ms, ls))
    o_g = sum(o * torch.exp(m - m_g)[..., None] for m, o in zip(ms, os_))
    return o_g, m_g, l_g
