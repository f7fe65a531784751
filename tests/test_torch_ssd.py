"""The port's plain SSD scan vs the reference's kernel and oracle.

``repro_torch.kernels.ref.ssd_scan_ref`` is the plain version the port's
SSD-scan wrapper runs on CPU tensors (and that ``chip_smoke.py`` holds the
CUDA kernel against).  Here it meets the reference's Pallas ``ssd_scan`` in
interpret mode (as tests/test_kernels.py runs it) and the reference's
``ref.ssd_scan_ref`` (the ``ssd_chunked`` oracle) on the same inputs,
drawn with numpy from a seed.  Tolerances are tests/test_kernels.py's: 3e-2
for bf16 inputs (bf16 x / B / C rounded identically in both packages; the
f32 sums run in another order) and 2e-4 for f32.  Under grad mode the
wrapper runs ``SSDScanFn``, whose CPU backward is the plain backward
(tests/test_torch_ssd_grad.py holds that against the reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

SHAPES = [
    (2, 128, 3, 16, 32, 32, False),     # tests/test_kernels.py:165-171
    (1, 256, 2, 64, 128, 128, True),
    (2, 64, 4, 8, 16, 16, True),
    (1, 96, 1, 32, 64, 32, False),
    (2, 144, 2, 16, 16, 48, True),      # Q = 48: not a power of two
    (1, 40, 2, 16, 32, 40, True),       # T = Q: one chunk
]


def _inputs(B, T, nh, hd, N, with_h0, dtype, seed=0):
    """numpy f32 arrays; x / B / C rounded to ``dtype`` so both packages
    see the same values."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return np.array(jnp.asarray(a, dtype).astype(jnp.float32))
    x = rnd(B, T, nh, hd)
    dt = rng.uniform(0.01, 0.2, size=(B, T, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(nh,)).astype(np.float32)
    Bm, Cm = rnd(B, T, nh, N), rnd(B, T, nh, N)
    h0 = (rng.normal(size=(B, nh, hd, N)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,nh,hd,N,Q,with_h0", SHAPES)
def test_ssd_scan_ref_matches_pallas_and_oracle(B, T, nh, hd, N, Q, with_h0,
                                                dtype):
    x, dt, A, Bm, Cm, h0 = _inputs(B, T, nh, hd, N, with_h0,
                                   getattr(jnp, dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt))
    jh0 = None if h0 is None else jnp.asarray(h0)
    targs = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
             torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
             torch.from_numpy(Cm).to(tdt))
    th0 = None if h0 is None else torch.from_numpy(h0)
    y_t, h_t = tref.ssd_scan_ref(*targs, chunk=Q, h0=th0)
    assert y_t.dtype == h_t.dtype == torch.float32
    assert y_t.shape == (B, T, nh, hd) and h_t.shape == (B, nh, hd, N)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    for y_j, h_j in (pallas_ssd_scan(*jargs, chunk=Q, h0=jh0),
                     jref.ssd_scan_ref(*jargs, chunk=Q, h0=jh0)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **tol)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **tol)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    """On CPU tensors ``ops.ssd_scan`` is the plain version, bit for bit,
    and launches no kernel."""
    x, dt, A, Bm, Cm, h0 = _inputs(1, 64, 2, 16, 16, True, jnp.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    before = ops.launch_counts()["ssd_scan"]
    y, h = ops.ssd_scan(*args, chunk=32, h0=torch.from_numpy(h0))
    y_r, h_r = tref.ssd_scan_ref(*args, chunk=32, h0=torch.from_numpy(h0))
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert ops.launch_counts()["ssd_scan"] == before


@pytest.mark.parametrize("needs_grad", ["x", "dt", "A", "Bm", "Cm", "h0"])
def test_wrapper_differentiates_each_input(needs_grad):
    """With grad mode on and one input requiring a gradient,
    ``ops.ssd_scan`` runs ``SSDScanFn``: its outputs are bit for bit the
    ``no_grad`` call's, and autograd's gradient of that input for a loss on
    both outputs is the plain backward's (on the CPU the function's
    backward is ``ref.ssd_scan_bwd_ref``, so bit for bit)."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _inputs(
        1, 64, 2, 16, 16, True, jnp.float32))
    inputs = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0)
    leaf = inputs[needs_grad] = inputs[needs_grad].clone().requires_grad_()
    kw = dict(chunk=32, h0=inputs.pop("h0"))
    y, h = ops.ssd_scan(*inputs.values(), **kw)
    assert "SSDScanFn" in type(y.grad_fn).__name__
    with torch.no_grad():
        y_r, h_r = tref.ssd_scan_ref(*inputs.values(), **kw)
    assert torch.equal(y.detach(), y_r) and torch.equal(h.detach(), h_r)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    ((y * dy).sum() + (h * dh).sum()).backward()
    plain = [t.detach() for t in inputs.values()]
    want = tref.ssd_scan_bwd_ref(*plain, dy, dh, chunk=32,
                                 h0=kw["h0"].detach())
    names = ["x", "dt", "A", "Bm", "Cm", "h0"]
    assert torch.equal(leaf.grad, want[names.index(needs_grad)])


def test_chunking_does_not_change_the_scan():
    """The scan is the same recurrence whatever the chunk: Q = 16, 48 and
    96 over T = 96 agree at f32 rounding (2e-4), and two calls chained
    through h0 equal one call over the concatenation."""
    x, dt, A, Bm, Cm, _ = _inputs(1, 96, 2, 16, 16, False, jnp.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y96, h96 = tref.ssd_scan_ref(*args, chunk=96)
    for Q in (16, 48):
        y, h = tref.ssd_scan_ref(*args, chunk=Q)
        torch.testing.assert_close(y, y96, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, h96, rtol=2e-4, atol=2e-4)
    first = [a[:, :48] for a in args[:2]] + [args[2]] + \
        [a[:, :48] for a in args[3:]]
    second = [a[:, 48:] for a in args[:2]] + [args[2]] + \
        [a[:, 48:] for a in args[3:]]
    y1, h1 = tref.ssd_scan_ref(*first, chunk=48)
    y2, h2 = tref.ssd_scan_ref(*second, chunk=48, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y96, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(h2, h96, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_ref_is_bitwise_the_head_expanded_call(G, dtype, with_h0):
    """B / C as [B, T, G, N] groups (head h reads group h // (nh // G), the
    models' un-expanded form): the plain version equals, bit for bit, its
    own result on the groups repeated to every head, and agrees with the
    reference's ``ssd_chunked`` oracle and its Pallas ``ssd_scan``
    (interpret mode) fed ``jnp.repeat``ed groups, at the tolerances
    above."""
    from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
    B, T, nh, hd, N, Q = 2, 96, 4, 16, 32, 48
    x, dt, A, Bm, Cm, h0 = _inputs(B, T, nh, hd, N, with_h0,
                                   getattr(jnp, dtype), seed=G)
    Bg, Cg = (np.ascontiguousarray(a[:, :, :G]) for a in (Bm, Cm))
    tdt = getattr(torch, dtype)
    th0 = None if h0 is None else torch.from_numpy(h0)
    tx, tdt_, tA = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                    torch.from_numpy(A))
    tBg, tCg = (torch.from_numpy(a).to(tdt) for a in (Bg, Cg))
    y, h = tref.ssd_scan_ref(tx, tdt_, tA, tBg, tCg, chunk=Q, h0=th0)
    rep = nh // G
    y_e, h_e = tref.ssd_scan_ref(
        tx, tdt_, tA, torch.repeat_interleave(tBg, rep, dim=2),
        torch.repeat_interleave(tCg, rep, dim=2), chunk=Q, h0=th0)
    assert torch.equal(y, y_e) and torch.equal(h, h_e)
    jdt = getattr(jnp, dtype)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
             jnp.repeat(jnp.asarray(Bg, jdt), rep, axis=2),
             jnp.repeat(jnp.asarray(Cg, jdt), rep, axis=2))
    jh0 = None if h0 is None else jnp.asarray(h0)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)
    for y_j, h_j in (jax_ssd_chunked(*jargs, Q, h0=jh0),
                     pallas_ssd_scan(*jargs, chunk=Q, h0=jh0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j, np.float32),
                                   **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_j, np.float32),
                                   **tol)


@pytest.mark.parametrize("G", [3, 8])
def test_wrapper_refuses_groups_that_do_not_divide_the_heads(G):
    """nh = 4 heads cannot read 3 or 8 B/C groups: the wrapper raises on
    CPU tensors as the kernel's wrapper does on CUDA ones."""
    x, dt, A, Bm, Cm, _ = _inputs(1, 32, 4, 16, 16, False, jnp.float32)
    Bg = np.random.default_rng(1).normal(size=(1, 32, G, 16)).astype(
        np.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bg, Bg)]
    with pytest.raises(ValueError, match="groups do not divide"):
        ops.ssd_scan(*args, chunk=16)
