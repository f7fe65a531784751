"""Prefill flash attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention.py``).  Causal or non-causal GQA attention
of queries at absolute positions ``q_offset .. q_offset + Tq - 1`` over
``Tk`` keys, optionally cut at ``kv_len`` per row: full prefill (``Tq ==
Tk``) and suffix-only prefill over a cached prefix (keys = the prefix's
then the suffix's, ``q_offset`` = the prefix length) run it once per layer,
causal; the encoder (``Tq == Tk``) and cross-attention (the decoder's rows
over the encoder memory: any ``Tq`` and ``Tk``, ``Tq = 1`` at decode) run
it non-causal.  A row's result does not depend on how many rows the call holds,
so a suffix call reproduces the full call's rows bit for bit.  Values may
be narrower than keys: MLA's expanded prefill has key width 192 and value
width 128 (:data:`HEAD_DIMS`).  bf16 inputs at head dims 32, 64, 96 and
128 and at MLA's 192 / 128 run on the tensor cores (``mma.sync``, f32
accumulate); f32 inputs and the other head dims run the CUDA-core path of
the same source.

For CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); for CUDA tensors it
launches the kernel or raises.  ``flash_attention.launches`` counts kernel
launches; a call that names its ``site`` (:data:`SITES`: the encoder and
the cross-attention at prefill and at decode) also adds its launch to
``flash_attention.site_launches[site]``.

Training: when grad mode is on and an input requires a gradient, the call
runs :class:`FlashAttentionFn`.  Its forward is the same kernel writing
each row's log-sum-exp as well (:func:`flash_attention_lse`, counted by
``flash_attention_lse.launches``, not ``flash_attention.launches``), and
its backward is ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`, plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`), counted by
``flash_attention_bwd.launches``: one per call, however many launches it
makes (bf16 at head dims 32-128 and at MLA's 192 / 128: dQ, which also
writes D, then dK / dV in thread-block clusters on ``wgmma``; otherwise the
D pre-pass, dK / dV and dQ on CUDA cores).  A differentiated call that
names its site (the encoder, or ``cross_prefill`` for the decoder's rows
over the whole memory) also counts under
``flash_attention_lse.site_launches[site]`` and
``flash_attention_bwd.site_launches[site]``, never under the serving
call's.  Training takes queries at positions 0 .. Tq - 1 (no
``q_offset``, no ``kv_len``), the widths of :data:`HEAD_DIMS` (MLA's
expanded attention included: dq and dk 192 wide, dv 128) and bf16 or
f32.  Serving calls run under ``no_grad`` and never take this path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# (key width, value width) pairs the kernel takes: equal widths in multiples
# of 32 up to 256, and MLA's expanded prefill (nope 128 + rope 64, v 128).
HEAD_DIMS = tuple((d, d) for d in range(32, 257, 32)) + ((192, 128),)
MAX_GROUP = 64          # query heads per KV head the kernel's CTA can hold
SITES = ("encoder", "cross_prefill", "cross_decode")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len=None, scale=None, site=None):
    """q [B, Tq, H, dh]; k [B, Tk, n_kv, dh], v [B, Tk, n_kv, dh_v] in q's
    dtype (bf16 or f32); kv_len int32 [B] or None; ``site`` one of
    :data:`SITES` or None.  Returns [B, Tq, H, dh_v] in q's dtype."""
    if site is not None and site not in SITES:
        raise ValueError(f"unknown flash-attention site {site!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset or kv_len is not None:
            raise ValueError("a differentiated flash attention takes no "
                             "q_offset or kv_len")
        return FlashAttentionFn.apply(q, k, v, causal, scale, site)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_len=kv_len,
                                       scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_inputs(q, k, v, kv_len, q_offset)
    B, Tq, H, dh = q.shape
    Tk, n_kv = k.shape[1:3]
    dh_v = v.shape[-1]
    scale = dh ** -0.5 if scale is None else scale
    o = q.new_empty((B, Tq, H, dh_v))
    if B == 0 or Tq == 0:
        return o
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
        None if kv_len is None else kv_len.data_ptr(), B, Tq, Tk, H, n_kv,
        dh, dh_v, int(q_offset), int(bool(causal)), int(q.dtype == torch.float32),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    if site is not None:
        flash_attention.site_launches[site] += 1
    return o


flash_attention.launches = 0
flash_attention.site_launches = dict.fromkeys(SITES, 0)


def flash_attention_lse(q, k, v, *, causal: bool = True, scale=None,
                        site=None):
    """The training forward: (o, lse) with lse f32 [B, H, Tq] each row's
    log-sum-exp of its scaled scores; on the card ``o`` is bit for bit the
    serving call's.  Queries at positions 0 .. Tq - 1; ``site`` one of
    :data:`SITES` or None."""
    if site is not None and site not in SITES:
        raise ValueError(f"unknown flash-attention site {site!r}")
    if q.device.type == "cpu":
        return ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_inputs(q, k, v, None, 0)
    B, Tq, H, dh = q.shape
    Tk, n_kv = k.shape[1:3]
    dh_v = v.shape[-1]
    scale = dh ** -0.5 if scale is None else scale
    o = q.new_empty((B, Tq, H, dh_v))
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None, B, Tq, Tk, H, n_kv, dh, dh_v, 0,
        int(bool(causal)), int(q.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_fwd")
    flash_attention_lse.launches += 1
    if site is not None:
        flash_attention_lse.site_launches[site] += 1
    return o, lse


flash_attention_lse.launches = 0
flash_attention_lse.site_launches = dict.fromkeys(SITES, 0)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        scale=None, site=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_lse`'s ``o`` given
    its gradient ``do``, in the inputs' dtypes.  Deterministic on the card
    (no atomics; the query heads' dK / dV partials are summed in a fixed
    order): two calls on the same inputs give the same bits.  A refused
    launch (a cluster the card cannot place, a tensor map it cannot
    encode) raises.  ``o`` and ``do`` must be [B, Tq, H, dh_v] in q's dtype
    and ``lse`` f32 [B, H, Tq], on every device.  ``site``: as
    :func:`flash_attention_lse`'s."""
    if site is not None and site not in SITES:
        raise ValueError(f"unknown flash-attention site {site!r}")
    B, Tq, H, dh = q.shape
    Tk, n_kv = k.shape[1:3]
    dh_v = v.shape[-1]
    for name, t, shape, dtype in (("o", o, (B, Tq, H, dh_v), q.dtype),
                                  ("do", do, (B, Tq, H, dh_v), q.dtype),
                                  ("lse", lse, (B, H, Tq), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"{name} must be {dtype} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                           causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_inputs(q, k, v, None, 0)
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    scale = dh ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    D = torch.empty_like(lse)
    lib = _bwd_lib()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, H, n_kv, dh, dh_v,
        int(bool(causal)), int(q.dtype == torch.float32), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    if site is not None:
        flash_attention_bwd.site_launches[site] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.site_launches = dict.fromkeys(SITES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its hand-written backward (queries at
    positions 0 .. Tq - 1).  Saves q, k, v, o and lse; both passes count
    under the call's site."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, site):
        o, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                     site=site)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.site = causal, scale, site
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal, scale=ctx.scale,
                                         site=ctx.site)
        return dq, dk, dv, None, None, None


def _check_inputs(q, k, v, kv_len, q_offset) -> None:
    """Raise on what the kernel does not take (device, dtype, shape,
    contiguity, alignment)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)} must be [B, Tq, H, dh], k "
                         f"{tuple(k.shape)} [B, Tk, n_kv, dh] and v "
                         f"{tuple(v.shape)} [B, Tk, n_kv, dh_v]")
    B, Tq, H, dh = q.shape
    Bk, Tk, n_kv, dh_k = k.shape
    if Bk != B or dh_k != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if (dh, v.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} (value {v.shape[-1]}) unsupported: "
                         f"equal multiples of 32 up to 256, or 192 / 128")
    if H % n_kv or H // n_kv > MAX_GROUP:
        raise ValueError(f"{H} query heads do not group over {n_kv} KV "
                         f"heads in groups of at most {MAX_GROUP}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {q.dtype} unsupported (bfloat16 or "
                         f"float32)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if kv_len is not None:
        if kv_len.shape != (B,) or kv_len.dtype != torch.int32:
            raise ValueError(f"kv_len must be int32 [{B}], got "
                             f"{kv_len.dtype} {tuple(kv_len.shape)}")
        if kv_len.device != q.device or not kv_len.is_contiguous():
            raise ValueError("kv_len must be contiguous and on q's device")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                        I, I, I, I, ctypes.c_float, P]
    lib.flash_attention_fwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = [P] * 10 + [I] * 9 + [ctypes.c_float,
                                                             P]
    lib.flash_attention_bwd.restype = I
    return lib
