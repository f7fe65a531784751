"""The gradient of the port's flash attention against the reference's.

The reference trains through its blockwise online-softmax attention
(``repro.models.layers.attention``), differentiated by ``jax.grad``; the
port has an explicit backward (``ref.flash_attention_bwd_ref``, the plain
version of ``csrc/flash_attention_bwd.cu``) behind an autograd function.
On CPU tensors that function runs the plain versions.  Inputs are drawn
with numpy from a seed and handed to both packages.  Tolerance: 2e-5 of
each gradient's scale in f32 (other summation order).  Values may be
narrower than keys (MLA's expanded attention: 24 / 16 at the smoke
config, 192 / 128 at deepseek-v2-lite's widths), which the wrapper's
shape checks follow on every device.  The CUDA kernels are held against
the same plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py phase 9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as j_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttentionFn

TOL = 2e-5

# (B, Tq, Tk, H, n_kv, dh, block): T off the block multiple; g = 1 and 4.
SHAPES = [
    (2, 37, 37, 4, 4, 16, 16),
    (1, 45, 45, 8, 2, 32, 32),
    (2, 21, 50, 8, 2, 16, 16),      # non-causal only: Tq != Tk
]


def _inputs(seed, B, Tq, Tk, H, n_kv, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, dh), (B, Tk, n_kv, dh), (B, Tk, n_kv, dh),
                      (B, Tq, H, dh))]


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (err, scale)


def _cases():
    for i, shape in enumerate(SHAPES):
        for causal in (True, False):
            if causal and shape[1] != shape[2]:
                continue
            yield pytest.param(shape, causal, id=f"{i}-{'causal' if causal else 'full'}")


def _autograd(fn, q, k, v, do):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fn(q, k, v)
    return (o,) + torch.autograd.grad(o, (q, k, v), torch.from_numpy(do))


@pytest.mark.parametrize("shape,causal", list(_cases()))
def test_bwd_ref_matches_autograd_of_plain_forward(shape, causal):
    B, Tq, Tk, H, n_kv, dh, _ = shape
    q, k, v, do = _inputs(0, B, Tq, Tk, H, n_kv, dh)
    o, *want = _autograd(
        lambda *a: ref.flash_attention_ref(*a, causal=causal), q, k, v, do)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o2, lse = ref.flash_attention_lse_ref(*t, causal=causal)
    assert torch.equal(o2, o.detach())
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    got = ref.flash_attention_bwd_ref(*t, o2, torch.from_numpy(do), lse,
                                      causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("shape,causal", list(_cases()))
def test_autograd_function_matches_jax_grad(shape, causal):
    """The port's flash attention under autograd (plain forward and
    backward on the CPU) against ``jax.grad`` of the reference's blockwise
    attention at a block that does not divide T."""
    B, Tq, Tk, H, n_kv, dh, block = shape
    q, k, v, do = _inputs(1, B, Tq, Tk, H, n_kv, dh)

    def j_loss(q, k, v):
        o = j_attention(q, k, v, causal=causal, block=block)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, j_o), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    ops.reset_launch_counts()
    o, *got = _autograd(
        lambda *a: ops.flash_attention(*a, causal=causal), q, k, v, do)
    assert o.grad_fn is not None and "FlashAttentionFn" in type(
        o.grad_fn).__name__
    _close(o, j_o)
    for g, w in zip(got, j_g):
        _close(g, w)
    # CPU tensors run the plain versions: no kernel launched.
    assert ops.train_launch_counts() == {"flash_attention.train": 0,
                                         "flash_attention_bwd": 0,
                                         "ssd_scan_bwd": 0}


def test_autograd_function_equals_plain_versions_bitwise():
    """On the CPU the function's forward is the lse plain forward and its
    backward is ``flash_attention_bwd_ref``, bit for bit."""
    q, k, v, do = _inputs(2, 2, 37, 37, 8, 2, 16)
    o, *got = _autograd(
        lambda *a: FlashAttentionFn.apply(*a, True, None, None), q, k, v, do)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o2, lse = ref.flash_attention_lse_ref(*t, causal=True)
    want = ref.flash_attention_bwd_ref(*t, o2, torch.from_numpy(do), lse,
                                       causal=True)
    assert torch.equal(o.detach(), o2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dh,dh_v,T", [(24, 16, 37), (192, 128, 21)])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_widths_backward_matches_jax_vjp(dh, dh_v, T, causal):
    """The plain forward with lse and backward at key width dh and value
    width dh_v (the smoke MLA's and deepseek-v2-lite's, scale dh^-0.5),
    through the autograd function and called directly, against
    ``jax.vjp`` of the reference's ``attention``: o [.., dh_v], dq and dk
    dh wide, dv dh_v wide."""
    rng = np.random.default_rng(6)
    B, H = 2, 4
    q, k = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.normal(size=(B, T, H, dh_v)).astype(np.float32)
             for _ in range(2))
    scale = dh ** -0.5
    j_o, vjp = jax.vjp(lambda q, k, v: j_attention(
        q, k, v, causal=causal, scale=scale, block=16),
        *(jnp.asarray(a) for a in (q, k, v)))
    j_g = vjp(jnp.asarray(do))
    o, *got = _autograd(lambda *a: ops.flash_attention(
        *a, causal=causal, scale=scale), q, k, v, do)
    assert o.shape == (B, T, H, dh_v)
    _close(o, j_o)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o2, lse = ops.flash_attention_lse(*t, causal=causal, scale=scale)
    direct = ops.flash_attention_bwd(*t, o2, torch.from_numpy(do), lse,
                                     causal=causal, scale=scale)
    for g, g2, w, width in zip(got, direct, j_g, (dh, dh, dh_v)):
        assert g.shape[-1] == width and torch.equal(g, g2)
        _close(g, w)


def test_backward_checks_grad_shapes_at_mla_widths():
    """o and dO are as wide as the values, lse is f32 [B, H, Tq]: the
    wrapper refuses others on the CPU as on the card."""
    rng = np.random.default_rng(8)
    q, k = (torch.from_numpy(rng.normal(size=(1, 16, 2, 24)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(1, 16, 2, 16)).astype(np.float32))
    o, lse = ops.flash_attention_lse(q, k, v)
    assert o.shape == (1, 16, 2, 16) and lse.shape == (1, 2, 16)
    ops.flash_attention_bwd(q, k, v, o, torch.ones_like(o), lse)
    with pytest.raises(ValueError, match="do must be"):
        ops.flash_attention_bwd(q, k, v, o, torch.ones_like(q), lse)
    with pytest.raises(ValueError, match="o must be"):
        ops.flash_attention_bwd(q, k, v, q, torch.ones_like(o), lse)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, k, v, o, torch.ones_like(o),
                                lse.double())


def test_serving_call_under_no_grad_keeps_its_path():
    q, k, v, _ = _inputs(3, 1, 20, 20, 4, 2, 16)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with torch.no_grad():
        o = ops.flash_attention(*t)
    assert o.grad_fn is None
    assert torch.equal(o, ref.flash_attention_ref(*t))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(*t, q_offset=4)


def test_differentiated_call_takes_only_known_sites():
    """A differentiated call may name its site (training's encoder and
    cross-attention do, for the card's counters); the site changes no
    value, and an unknown one raises."""
    q, k, v, do = _inputs(4, 2, 20, 24, 4, 4, 16)
    plain = _autograd(lambda *a: ops.flash_attention(*a, causal=False),
                      q, k, v, do)
    named = _autograd(lambda *a: ops.flash_attention(*a, causal=False,
                                                     site="cross_prefill"),
                      q, k, v, do)
    for a, b in zip(plain, named):
        assert torch.equal(a, b)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with pytest.raises(ValueError, match="site"):
        ops.flash_attention(*t, causal=False, site="decoder")


@pytest.mark.parametrize("source,group", [
    ("flash_attention.cu", "flash_forward"),
    ("flash_attention_bwd.cu", "flash_backward"),
    ("ssd_scan.cu", "ssd_forward"),
    ("ssd_scan_bwd.cu", "ssd_backward"),
])
def test_train_profile_groups_every_flash_kernel(source, group):
    """``launch/train_profile.py`` files a traced kernel under its group by
    name; every ``__global__`` kernel of the flash and SSD-scan sources,
    read from the source, must land in its group, so that a renamed or
    added kernel cannot slip into another group of the step's breakdown
    unseen."""
    import re
    from pathlib import Path

    from repro_torch.launch.train_profile import group_of
    csrc = Path(ops.__file__).resolve().parents[1] / "csrc"
    text = (csrc / source).read_text()
    # Launch bounds may hold one level of parentheses (a constexpr call).
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                       r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(", text)
    assert len(names) == text.count("__global__") >= 2
    # As the profiler names an instance: namespace, template arguments.
    assert {n: group_of(f"void (anonymous namespace)::{n}<128, 1>(int)")
            for n in names} == dict.fromkeys(names, group)
