"""Mamba-2 SSD chunked scan: wrapper of ``csrc/ssd_scan.cu``.

Replaces the reference's Pallas ``ssd_scan`` (``repro/kernels/ssd_scan.py``),
with its interface: x [B, T, nh, hd], dt [B, T, nh] (post-softplus), A [nh]
(negative), B / C [B, T, G, N] with G dividing nh (head h reads group
h // (nh // G); G = nh is the reference's head-expanded form, and the
models pass their un-expanded groups), an optional initial state
h0 [B, nh, hd, N]; returns y [B, T, nh, hd] and the final state
[B, nh, hd, N], both float32.  Every Mamba-2 layer of a prefill (the ssm and
hybrid families) runs it once.

For CPU tensors the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.ssd_scan_ref`); for CUDA tensors it launches
the kernel or raises.  A bf16 call is three launches (chunk states, state
pass, chunk outputs; the last two start early as programmatic dependents,
see the source's header); f32 is one.  ``ssd_scan.launches`` counts calls
that launched.

Training: when grad mode is on and an input requires a gradient, the call
runs :class:`SSDScanFn`, whose forward is the same call (so ``y`` and the
final state are bit for bit the ``no_grad`` call's) and whose backward is
:func:`ssd_scan_bwd`: on CUDA tensors ``csrc/ssd_scan_bwd.cu`` (seven
launches, one count in ``ssd_scan_bwd.launches``; bf16 runs its products
on the tensor cores (wgmma), each CTA of its two pair passes walking up
to :data:`BWD_MAX_HEADS` heads of a B/C group; f32 runs on CUDA cores), on
CPU tensors the plain version
:func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`.  The backward takes the
models' training shapes (:data:`BWD_DIMS`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

DIMS = (16, 32, 64, 128)   # head dims and state sizes the kernel takes
MAX_CHUNK = 256
# (head dim, state size) pairs the backward takes: mamba2-1.3b's and
# zamba2-1.2b's, and the smoke configs'.
BWD_DIMS = ((64, 128), (64, 64), (16, 16))
# Most heads of one B/C group that a CTA of the bf16 backward's pair
# passes walks in turn, summing their dB and dC before they leave it.
BWD_MAX_HEADS = 8


def bwd_heads(heads_per_group: int) -> int:
    """Heads a CTA of the bf16 backward's pair passes takes: the largest
    divisor of a group's heads up to :data:`BWD_MAX_HEADS`."""
    return max(k for k in range(1, BWD_MAX_HEADS + 1)
               if heads_per_group % k == 0)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """x in bf16 or f32, Bm / Cm [B, T, G, N] in x's dtype; dt [B, T, nh]
    and A [nh] f32; h0 f32 or None; T a multiple of ``chunk``.  Returns
    (y [B, T, nh, hd] f32, h_final [B, nh, hd, N] f32)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, h0)):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, h0, chunk)
    return _scan(x, dt, A, Bm, Cm, chunk, h0)


def _scan(x, dt, A, Bm, Cm, chunk, h0):
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD-scan path for device {x.device}")
    _check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    Bsz, T, nh, hd = x.shape
    G, N = Bm.shape[2:]
    dev = x.device
    y = torch.empty((Bsz, T, nh, hd), dtype=torch.float32, device=dev)
    h_out = torch.empty((Bsz, nh, hd, N), dtype=torch.float32, device=dev)
    if Bsz == 0 or nh == 0:
        return y, h_out
    is_f32 = x.dtype == torch.float32
    states = cum = hp = None
    if not is_f32:
        nc = T // chunk
        states = torch.empty((Bsz, nc, nh, hd, N), dtype=torch.float32,
                             device=dev)
        cum = torch.empty((Bsz, nh, T), dtype=torch.float32, device=dev)
        hp = torch.empty((2, Bsz, nc, nh, hd, N), dtype=torch.bfloat16,
                         device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), ptr(h0), y.data_ptr(), h_out.data_ptr(), ptr(states),
        ptr(cum), ptr(hp), Bsz, T, nh, G, hd, N, int(chunk), int(is_f32),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh=None, *, chunk: int, h0=None):
    """Gradients (dx, d dt, dA, dB, dC, dh0) of :func:`ssd_scan`'s (y,
    h_final) given dy [B, T, nh, hd] f32 and dh [B, nh, hd, N] f32 (None:
    zero), in the inputs' dtypes; dB / dC over the [B, T, G, N] groups;
    dh0 None without h0.  Deterministic on the card (no atomics): two calls
    give the same bits."""
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dh, chunk=chunk,
                                    h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD-scan path for device {x.device}")
    _check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    Bsz, T, nh, hd = x.shape
    G, N = Bm.shape[2:]
    if (hd, N) not in BWD_DIMS:
        raise ValueError(f"the backward takes (head dim, state size) in "
                         f"{BWD_DIMS}, not ({hd}, {N})")
    for name, t, shape in (("dy", dy, x.shape),
                           ("dh", dh, (Bsz, nh, hd, N))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} on {x.device}")
    dev, f32 = x.device, torch.float32
    is_f32 = x.dtype == torch.float32
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else torch.empty_like(h0)
    nc, nt = T // chunk, -(-chunk // 64)        # chunks, 64-row tiles
    heads = 1 if is_f32 else bwd_heads(nh // G)
    S, E = (torch.empty((Bsz, nc, nh, hd, N), dtype=f32, device=dev)
            for _ in range(2))
    cum_last, dA_part = (torch.empty((Bsz, nc, nh), dtype=f32, device=dev)
                         for _ in range(2))
    dBh, dCh = (torch.empty((Bsz, T, nh // heads, N), dtype=f32, device=dev)
                for _ in range(2))
    rows = torch.empty((4 if is_f32 else 6 + nt, Bsz, nh, T), dtype=f32,
                       device=dev)
    dys = hpg = ghp = None
    if not is_f32:
        bf16 = torch.bfloat16
        dys = torch.empty((2, Bsz, T, nh, hd), dtype=bf16, device=dev)
        hpg = torch.empty((4, Bsz, nc, nh, hd, N), dtype=bf16, device=dev)
        # <g, h_p> per warp of the state pass: 8 warps a 1024 elements
        ghp = torch.empty((Bsz, nc, nh, 8 * -(-hd * N // 1024)), dtype=f32,
                          device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _bwd_lib()
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), ptr(h0), dy.data_ptr(), ptr(dh), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptr(dh0),
        S.data_ptr(), E.data_ptr(), cum_last.data_ptr(), dBh.data_ptr(),
        dCh.data_ptr(), rows.data_ptr(), dA_part.data_ptr(), ptr(dys),
        ptr(hpg), ptr(ghp), Bsz, T, nh, G, hd, N, int(chunk), int(is_f32),
        heads, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dh0


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with its backward (:func:`ssd_scan_bwd`).  Saves the
    inputs: the backward recomputes the chunk states itself, so no forward
    scratch outlives the call.  A missing gradient of either output counts
    as zero (the final state's is unused in training)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h = _scan(x, dt, A, Bm, Cm, chunk, h0)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(
            x, dt, A, Bm, Cm, dy.contiguous(),
            None if dh is None else dh.contiguous(), chunk=ctx.chunk, h0=h0)
        return (dx, ddt, dA, dB, dC,
                dh0 if ctx.needs_input_grad[5] else None, None)


def _check_inputs(x, dt, A, Bm, Cm, chunk, h0) -> None:
    """Raise on what the kernel does not take (device, dtype, shape,
    contiguity, alignment)."""
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"x {tuple(x.shape)} must be [B, T, nh, hd] and "
                         f"Bm / Cm {tuple(Bm.shape)} / {tuple(Cm.shape)} one "
                         f"[B, T, G, N] shape")
    Bsz, T, nh, hd = x.shape
    G, N = Bm.shape[2:]
    if Bm.shape[:2] != x.shape[:2]:
        raise ValueError(f"Bm {tuple(Bm.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if G < 1 or nh % G:
        raise ValueError(f"{G} B/C groups do not divide {nh} heads")
    if dt.shape != (Bsz, T, nh) or A.shape != (nh,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} must "
                         f"be [{Bsz}, {T}, {nh}] / [{nh}]")
    if hd not in DIMS or N not in DIMS:
        raise ValueError(f"head dim {hd} / state size {N} unsupported: "
                         f"{DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK} and "
                         f"divide T={T}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {x.dtype} unsupported (bfloat16 or "
                         f"float32)")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x {x.dtype}")
    tensors = [("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)]
    if h0 is not None:
        if h0.shape != (Bsz, nh, hd, N):
            raise ValueError(f"h0 {tuple(h0.shape)} must be "
                             f"[{Bsz}, {nh}, {hd}, {N}]")
        tensors.append(("h0", h0))
    for name, t in (("dt", dt), ("A", A), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.library("ssd_scan"))


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("ssd_scan_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [P] * 24 + [I] * 9 + [P]
    lib.ssd_scan_bwd.restype = I
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entry's argument types on a built ``ssd_scan.cu``."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                                 I, I, I, I, P]
    lib.ssd_scan_fwd.restype = I
    return lib
