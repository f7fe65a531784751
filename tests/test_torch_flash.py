"""The port's prefill flash attention (plain version) vs the reference's.

On CPU tensors ``repro_torch.kernels.flash_attention.flash_attention`` runs
its plain version, ``ref.flash_attention_ref`` (the blockwise loop of
``models/layers.attention``).  It is held against the reference's Pallas
``flash_attention`` in interpret mode, as tests/test_kernels.py runs it
(causal and not, 1, 2 and 4 query heads per KV head, T a multiple of the
Pallas blocks), and against the reference's ``flash_attention_ref`` with
the suffix-prefill arguments ``q_offset`` and ``kv_len``.  Inputs are drawn
with numpy from a seed and handed to both.  Tolerances: f32 2e-5 and bf16
2e-2, those of tests/test_kernels.py (other summation order; bf16 rounds
at other places in the two frameworks).  The CUDA kernel is held against
the same plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, Tq, Tk, H, n_kv, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Tq, H, dh)).astype(np.float32),
            rng.normal(size=(B, Tk, n_kv, dh)).astype(np.float32),
            rng.normal(size=(B, Tk, n_kv, dh)).astype(np.float32))


def _both(arrays, name):
    jdt, tdt = DTYPES[name]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,T,H,n_kv,dh,bq,bk", [
    (2, 128, 4, 4, 32, 64, 64),      # g = 1
    (1, 256, 8, 4, 64, 64, 128),     # g = 2
    (2, 192, 8, 2, 16, 64, 192),     # g = 4, T not a power of two
])
def test_plain_flash_matches_pallas_interpret(B, T, H, n_kv, dh, bq, bk,
                                              causal, dtype):
    (qj, kj, vj), (qt, kt, vt) = _both(_inputs(0, B, T, T, H, n_kv, dh),
                                      dtype)
    want = j_flash(qj, kj, vj, causal=causal, bq=bq, bk=bk)
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,q_offset,with_len,causal", [
    (24, 64, 40, False, True),     # suffix prefill: P = 40 cached keys
    (9, 40, 31, True, True),       # ragged suffix, rows cut at kv_len
    (16, 16, 0, True, False),      # non-causal with kv_len
    (600, 600, 0, False, True),    # more than one 512-key block
])
def test_plain_flash_matches_reference_oracle(Tq, Tk, q_offset, with_len,
                                              causal, dtype):
    B, H, n_kv, dh = 2, 8, 2, 32
    (qj, kj, vj), (qt, kt, vt) = _both(
        _inputs(1, B, Tq, Tk, H, n_kv, dh), dtype)
    kv_len = np.array([Tk, Tk - 5], np.int32) if with_len else None
    kw = dict(causal=causal, q_offset=q_offset, scale=0.3)
    want = jref.flash_attention_ref(
        qj, kj, vj, kv_len=None if kv_len is None else jnp.asarray(kv_len),
        **kw)
    got = flash_attention(
        qt, kt, vt, kv_len=None if kv_len is None else torch.from_numpy(
            kv_len), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    _, (q, k, v) = _both(_inputs(2, 1, 20, 52, 4, 2, 64), "bfloat16")
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, q_offset=32)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=32)
    assert torch.equal(got, want)
    assert ops.launch_counts()["flash_attention"] == before
    assert "flash_attention" in ops.KERNELS


def test_wrapper_refuses_other_devices():
    _, (q, k, v) = _both(_inputs(3, 1, 4, 4, 2, 1, 32), "float32")
    with pytest.raises(ValueError, match="no flash-attention path"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
