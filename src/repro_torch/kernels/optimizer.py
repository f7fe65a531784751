"""Optimizer-step kernels: wrappers of ``csrc/adamw.cu`` and
``csrc/grad_quant.cu``.

Neither replaces a Pallas kernel: the reference's AdamW update and its
``grad_compress`` quantise pass are plain jnp that XLA fuses into one loop
per leaf inside the jitted ``train_step``.  Here each is one hand-written
pass over a leaf:

* :func:`adamw_leaf`: AdamW on one leaf in place (p, m, v written; g
  read), called by :func:`repro_torch.train.optimizer.adamw_update` once
  per leaf;
* :func:`grad_quant`: block int8 quantisation of a flat f32 vector, with
  error feedback in place (``compressed_allreduce_flat``) or as the ring's
  per-hop quantiser (``_quant``).

For CPU tensors each wrapper runs its plain version
(:func:`repro_torch.kernels.ref.adamw_leaf_ref`,
:func:`~repro_torch.kernels.ref.ef_quant_ref`,
:func:`~repro_torch.kernels.ref.quant_ref`); for CUDA tensors it launches
its kernel, bit for bit the plain version on the card, or raises (a
tensor not contiguous, not 16-byte aligned, of another dtype or device).
Each wrapper's ``launches`` attribute counts its kernel launches; an empty
leaf launches nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, ref

BLOCK = ref.QUANT_BLOCK


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t, name, dev, dtypes):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                         f"{', '.join(str(d) for d in dtypes)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _adamw_lib() -> ctypes.CDLL:
    lib = build.library("adamw")
    P = ctypes.c_void_p
    lib.adamw_leaf.argtypes = [P, P, P, P, P, ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong, P, P]
    lib.adamw_leaf.restype = ctypes.c_int
    return lib


def _hyper(*, lr, c1, c2, decay, b1, b2, eps) -> np.ndarray:
    """The kernel's nine f32 scalars, rounded as PyTorch rounds the eager
    chain's: Python floats (``b1``, ``1 - b1`` taken in double, ...) to f32
    once; ``lr``, ``c1``, ``c2``, ``decay`` are f32 already (0-d CPU
    tensors); ``1 / c1`` and ``1 / c2`` in f32, as ``div_true_kernel_cuda``
    takes the reciprocal of a CPU scalar divisor."""
    f = np.float32
    return np.array([b1, 1 - b1, b2, 1 - b2, f(1) / f(float(c1)),
                     f(1) / f(float(c2)), eps, float(lr), float(decay)],
                    dtype=np.float32)


def adamw_leaf(p, g, mu, nu, scale, *, lr, c1, c2, decay, b1, b2, eps):
    """AdamW on one leaf in place: ``p`` f32 or bf16, ``g`` f32 or bf16
    (read), ``mu`` / ``nu`` f32, all of one shape; ``scale`` the clip
    factor, an f32 0-d tensor on their device (read by the kernel: no
    synchronisation); ``lr``, ``c1``, ``c2``, ``decay`` f32 0-d CPU
    tensors; ``b1``, ``b2``, ``eps`` floats.  On the CPU the plain version,
    which also overwrites an f32 ``g``.  Returns ``p``."""
    kw = dict(lr=lr, c1=c1, c2=c2, decay=decay, b1=b1, b2=b2, eps=eps)
    if p.device.type == "cpu":
        return ref.adamw_leaf_ref(p, g, mu, nu, scale, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"no AdamW path for device {p.device}")
    dev, floats = p.device, (torch.float32, torch.bfloat16)
    _check(p, "p", dev, floats)
    _check(g, "g", dev, floats)
    for t, name in ((mu, "mu"), (nu, "nu")):
        _check(t, name, dev, (torch.float32,))
    if not (p.shape == g.shape == mu.shape == nu.shape):
        raise ValueError(f"p {tuple(p.shape)}, g {tuple(g.shape)}, mu "
                         f"{tuple(mu.shape)} and nu {tuple(nu.shape)} "
                         f"differ")
    if scale.device != dev or scale.dtype != torch.float32 \
            or scale.numel() != 1:
        raise ValueError(f"scale must be one f32 on {dev}, got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    n = p.numel()
    if n == 0:
        return p
    hyper = _hyper(**kw)
    lib = _adamw_lib()
    err = lib.adamw_leaf(p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                         nu.data_ptr(), scale.data_ptr(),
                         int(p.dtype == torch.bfloat16),
                         int(g.dtype == torch.bfloat16), n,
                         hyper.ctypes.data, _stream(p))
    build.check(lib, err, "adamw_leaf")
    adamw_leaf.launches += 1
    return p


adamw_leaf.launches = 0


@functools.lru_cache(maxsize=None)
def _quant_lib() -> ctypes.CDLL:
    lib = build.library("grad_quant")
    P = ctypes.c_void_p
    lib.grad_quant.argtypes = [P, P, P, P, ctypes.c_longlong, P]
    lib.grad_quant.restype = ctypes.c_int
    return lib


def grad_quant(x, err=None):
    """Block int8 quantisation of a flat f32 vector ``x`` whose length is a
    multiple of 256 (else ValueError, on every device).

    ``err`` None (quantise mode): returns (q int8 [n / 256, 256], scales
    f32 [n / 256]); ``x`` is not written.  ``err`` an f32 vector like
    ``x`` (error feedback, in place): ``err`` becomes e' = (x + e) -
    Q(x + e) and ``x`` Q(x + e), dequantised; returns (x, err)."""
    if x.dim() != 1 or x.numel() % BLOCK:
        raise ValueError(f"grad_quant takes a flat vector whose length is a "
                         f"multiple of {BLOCK}, got {tuple(x.shape)}")
    if err is not None and err.shape != x.shape:
        raise ValueError(f"err {tuple(err.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        if err is None:
            return ref.quant_ref(x)
        return ref.ef_quant_ref(x, err)
    if x.device.type != "cuda":
        raise ValueError(f"no quantiser path for device {x.device}")
    dev = x.device
    _check(x, "x", dev, (torch.float32,))
    if err is not None:
        _check(err, "err", dev, (torch.float32,))
    n_blocks = x.numel() // BLOCK
    q = s = None
    if err is None:
        q = torch.empty((n_blocks, BLOCK), dtype=torch.int8, device=dev)
        s = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    if n_blocks:
        lib = _quant_lib()
        code = lib.grad_quant(x.data_ptr(),
                              None if err is None else err.data_ptr(),
                              None if q is None else q.data_ptr(),
                              None if s is None else s.data_ptr(), n_blocks,
                              _stream(x))
        build.check(lib, code, "grad_quant")
        grad_quant.launches += 1
    return (q, s) if err is None else (x, err)


grad_quant.launches = 0
