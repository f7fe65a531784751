"""Base-page movement: wrappers of ``csrc/page_copy.cu``.

Replace the reference's Pallas ``page_gather``, ``page_scatter`` and
``page_compact`` (``repro/kernels/page_compact.py``): the device halves of
host-tier demand paging (eviction gather, fault-in scatter) and the CAC
compaction copy plan.  Pools are layer-stacked ``[L, NP, ...]`` and one
launch covers every layer.  Scatter and compact update the pool **in
place** and return it.

For CPU tensors each wrapper runs its plain version from
:mod:`repro_torch.kernels.ref`; for CUDA tensors it launches its kernel or
raises.  Each wrapper's ``launches`` attribute counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("page_copy")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.page_gather, lib.page_scatter, lib.page_compact):
        fn.argtypes = [P, P, P, I, I, LL, LL, P]
        fn.restype = I
    return lib


def _check_pool(pool, *indices):
    """Validate a CUDA launch; returns (L, NP, page_bytes)."""
    if pool.dim() < 2:
        raise ValueError(f"pool must be [L, NP, ...], got {tuple(pool.shape)}")
    if not pool.is_contiguous() or pool.data_ptr() % 16:
        raise ValueError("pool must be contiguous and 16-byte aligned")
    L, NP = pool.shape[:2]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    if page_bytes % 16:
        raise ValueError(f"page of {page_bytes} bytes is not a multiple of "
                         f"16 (the kernels copy 16-byte vectors)")
    if L > 65535:
        raise ValueError(f"{L} layers exceed the launch grid")
    for t in indices:
        if t.device != pool.device or t.dtype != torch.int32 \
                or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("page indices must be contiguous 1-D int32 on "
                             "the pool's device")
    return L, NP, page_bytes


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def page_gather(pool, idx):
    """pool [L, NP, ...]; idx int32 [n] → pages [L, n, ...]; a hole
    (idx < 0) reads page 0 (callers mask them out)."""
    if pool.device.type == "cpu":
        return ref.page_gather_ref(pool, idx)
    L, NP, page_bytes = _check_pool(pool, idx)
    n = idx.shape[0]
    out = torch.empty((L, n, *pool.shape[2:]), dtype=pool.dtype,
                      device=pool.device)
    if n == 0:
        return out
    lib = _lib()
    err = lib.page_gather(pool.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          n, L, NP, page_bytes, _stream(pool))
    build.check(lib, err, "page_gather")
    page_gather.launches += 1
    return out


def page_scatter(pool, idx, pages):
    """pool[l, idx[i]] = pages[l, i] in place (holes are no-ops); returns
    pool."""
    if pool.device.type == "cpu":
        return ref.page_scatter_ref(pool, idx, pages)
    L, NP, page_bytes = _check_pool(pool, idx)
    n = idx.shape[0]
    if pages.shape != (L, n, *pool.shape[2:]) or pages.dtype != pool.dtype \
            or pages.device != pool.device or not pages.is_contiguous() \
            or pages.data_ptr() % 16:
        raise ValueError(f"pages {tuple(pages.shape)} {pages.dtype} must be "
                         f"contiguous [L, n, ...] like the pool")
    if n == 0:
        return pool
    lib = _lib()
    err = lib.page_scatter(pool.data_ptr(), idx.data_ptr(), pages.data_ptr(),
                           n, L, NP, page_bytes, _stream(pool))
    build.check(lib, err, "page_scatter")
    page_scatter.launches += 1
    return pool


def page_compact(pool, src, dst):
    """pool[l, dst[i]] = pool[l, src[i]] in place (entries with src or dst
    < 0 are no-ops; a src is never also a dst); returns pool."""
    if pool.device.type == "cpu":
        return ref.page_compact_ref(pool, src, dst)
    L, NP, page_bytes = _check_pool(pool, src, dst)
    n = src.shape[0]
    if dst.shape[0] != n:
        raise ValueError(f"src has {n} entries, dst {dst.shape[0]}")
    if n == 0:
        return pool
    lib = _lib()
    err = lib.page_compact(pool.data_ptr(), src.data_ptr(), dst.data_ptr(),
                           n, L, NP, page_bytes, _stream(pool))
    build.check(lib, err, "page_compact")
    page_compact.launches += 1
    return pool


page_gather.launches = 0
page_scatter.launches = 0
page_compact.launches = 0
