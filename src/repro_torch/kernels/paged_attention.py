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

For CPU tensors the wrappers run the plain versions
(:func:`repro_torch.kernels.ref.paged_attention_ref`,
:func:`~repro_torch.kernels.ref.fused_paged_attention_ref`); for CUDA
tensors they launch the kernel or raise.  ``paged_attention_kernel.
page_launches`` / ``.frame_launches`` and ``fused_paged_attention_kernel.
fused_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = tuple(range(32, 257, 32))


def paged_attention_kernel(q, pool_k, pool_v, tables, ntok, *,
                           granularity: str, frame_pages: int = 16,
                           scale: float = 1.0):
    """q [B, H, dh]; pool_k/v [NP, ptok, n_kv, dh] (bf16 or f32);
    tables/ntok int32 [B, n_blocks] (page or frame ids, -1 holes; valid
    tokens per block).  Returns (o [B,H,dh] f32, m [B,H] f32, l [B,H] f32).
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
    qf = q.float().contiguous()
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, m, l
    lib = _lib()
    err = lib.paged_attention_fwd(
        qf.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), ntok.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, H, n_kv, dh, tables.shape[1], fp * ptok,
        int(pool_k.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "paged_attention_fwd")
    if granularity == "page":
        paged_attention_kernel.page_launches += 1
    else:
        paged_attention_kernel.frame_launches += 1
    return o, m, l


paged_attention_kernel.page_launches = 0
paged_attention_kernel.frame_launches = 0


def _check_inputs(q, pool_k, pool_v, tables, ntok, fp: int) -> None:
    """Raise on what the kernels do not take (device, dtype, shape,
    contiguity, alignment)."""
    B, H, dh = q.shape
    NP, _ptok, n_kv, dh_k = pool_k.shape
    if pool_v.shape != pool_k.shape or dh_k != dh:
        raise ValueError(f"pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q {tuple(q.shape)}"
                         f" (a value head dim != key head dim is not ported)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} unsupported: multiples of 32 up "
                         f"to 256")
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
    _check_inputs(q, pool_k, pool_v, tables, ntok, 1)
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
    qf = q.float().contiguous()
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return o, m, l
    lib = _lib()
    err = lib.fused_paged_attention_fwd(
        qf.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        stage_k.data_ptr() if NS else None,
        stage_v.data_ptr() if NS else None, tables.data_ptr(),
        slots.data_ptr(), ntok.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, H, n_kv, dh, tables.shape[1], ptok,
        int(pool_k.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "fused_paged_attention_fwd")
    fused_paged_attention_kernel.fused_launches += 1
    return o, m, l


fused_paged_attention_kernel.fused_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_fwd.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I,
                                        I, I, I, ctypes.c_float, P]
    lib.paged_attention_fwd.restype = I
    lib.fused_paged_attention_fwd.argtypes = [P, P, P, P, P, P, P, P, P, P,
                                              P, I, I, I, I, I, I, I,
                                              ctypes.c_float, P]
    lib.fused_paged_attention_fwd.restype = I
    return lib


def combine_granularities(parts):
    """Flash-combine [(o, m, l), ...] partials from both granularities."""
    os_, ms, ls = zip(*parts)
    m_g = functools.reduce(torch.maximum, ms)
    l_g = sum(l * torch.exp(m - m_g) for m, l in zip(ms, ls))
    o_g = sum(o * torch.exp(m - m_g)[..., None] for m, o in zip(ms, os_))
    return o_g, m_g, l_g
