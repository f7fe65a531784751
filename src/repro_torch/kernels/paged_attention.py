"""Paged decode attention, both granularities: wrapper of ``csrc/paged_attention.cu``.

Replaces the reference's Pallas ``paged_attention_kernel``
(``repro/kernels/paged_attention.py``).  ``granularity="page"`` walks one
base page per table entry (the splintered path); ``"frame"`` walks one
coalesced, aligned frame of ``frame_pages`` pages per entry (the paper's
large-page fast path: one table lookup per frame).  Both return
unnormalized fp32 ``(o, m, l)`` partials that :func:`combine_granularities`
flash-combines.

For CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.paged_attention_ref`); for CUDA tensors it
launches the kernel or raises.  ``paged_attention_kernel.page_launches`` and
``.frame_launches`` count kernel launches per granularity.
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
    B, H, dh = q.shape
    NP, ptok, n_kv, dh_k = pool_k.shape
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_fwd.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I,
                                        I, I, I, ctypes.c_float, P]
    lib.paged_attention_fwd.restype = I
    return lib


def combine_granularities(parts):
    """Flash-combine [(o, m, l), ...] partials from both granularities."""
    os_, ms, ls = zip(*parts)
    m_g = functools.reduce(torch.maximum, ms)
    l_g = sum(l * torch.exp(m - m_g) for m, l in zip(ms, ls))
    o_g = sum(o * torch.exp(m - m_g)[..., None] for m, o in zip(ms, os_))
    return o_g, m_g, l_g
