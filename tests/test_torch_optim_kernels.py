"""The optimizer-step kernels' CPU route against the reference, on the CPU.

``kernels/optimizer.py``'s ``adamw_leaf`` (the fused AdamW update,
``csrc/adamw.cu`` on the card) and ``grad_quant`` (the error-feedback
quantiser of ``grad_compress``, ``csrc/grad_quant.cu``) run their plain
versions on CPU tensors; here those are held against the reference's
``repro.train.optimizer.adamw_update`` (1e-6 of each tensor's scale: the
same f32 operations in another fusion, a bf16 parameter rounded once at
the end in both) and ``repro.train.grad_compress`` (bit for bit: the same
operations on the same numbers).  Inputs come from numpy
seeds.  The kernels themselves are held against these plain versions on
the card (``tests/test_torch_cuda.py``, marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs.base import TrainHParams as JHP
from repro.train import grad_compress as j_gc
from repro.train import optimizer as j_opt
from repro_torch.configs.base import TrainHParams
from repro_torch.kernels import ops, ref
from repro_torch.kernels.optimizer import BLOCK, adamw_leaf, grad_quant
from repro_torch.train import grad_compress as gc
from repro_torch.train.optimizer import adamw_init, adamw_scalars, global_norm

SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 3, 4), "d": (0, 4),
          "e": (4099,)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread, so that workers running side by
    side do not spin against each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want):
    """Largest absolute difference over the reference tensor's scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_step(tp, tg, ts, hp):
    """One AdamW step through ``adamw_leaf`` on each leaf (the update the
    kernel runs), with ``adamw_update``'s clip scale and scalars."""
    step = ts["step"] + 1
    gn = global_norm(tg.values())
    scale = torch.clamp(hp.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr, c1, c2, decay = adamw_scalars(hp, step)
    for n, p in tp.items():
        adamw_leaf(p, tg[n], ts["mu"][n], ts["nu"][n], scale, lr=lr, c1=c1,
                   c2=c2, decay=decay, b1=hp.b1, b2=hp.b2, eps=hp.eps)
    return {"step": step, "mu": ts["mu"], "nu": ts["nu"]}, gn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_adamw_leaf_matches_the_reference(clip, dtype):
    """Three steps of ``adamw_leaf`` over five leaves (one empty, one with
    a vector tail) against the reference's ``adamw_update``; ``clip`` 0.05
    clips every step; bf16 p and g, or f32.  p and the moments at 1e-6 of
    their scale."""
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
              weight_decay=0.1)
    jp = {n: jnp.asarray(a).astype(jdt) for n, a in p0.items()}
    js = j_opt.adamw_init(jp)
    tp = {n: torch.from_numpy(a.copy()).to(tdt) for n, a in p0.items()}
    ts = adamw_init(tp)
    hp = TrainHParams(**kw)
    ops.reset_launch_counts()
    for it in range(3):
        g = {n: rng.normal(size=s).astype(np.float32)
             for n, s in SHAPES.items()}
        jp, js, jm = j_opt.adamw_update(
            jp, {n: jnp.asarray(a).astype(jdt) for n, a in g.items()}, js,
            JHP(**kw))
        ts, gn = _leaf_step(
            tp, {n: torch.from_numpy(a.copy()).to(tdt) for n, a in g.items()},
            ts, hp)
        assert int(ts["step"]) == int(js["step"]) == it + 1
        assert float(gn) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        if clip < 1:
            assert float(gn) > clip
        for n in SHAPES:
            assert _rel(ts["mu"][n].numpy(), js["mu"][n]) <= 1e-6
            assert _rel(ts["nu"][n].numpy(), js["nu"][n]) <= 1e-6
            got = tp[n].float().numpy()
            want = np.asarray(jp[n].astype(jnp.float32))
            assert _rel(got, want) <= 1e-6
    # The CPU route runs the plain version: nothing launched.
    assert ops.train_launch_counts()["adamw"] == 0


def test_adamw_leaf_cpu_route_is_the_plain_version_bitwise():
    """On CPU tensors ``adamw_leaf`` is ``adamw_leaf_ref``, bit for bit,
    f32 and bf16 parameters alike."""
    rng = np.random.default_rng(9)
    kw = dict(zip(("lr", "c1", "c2", "decay"), adamw_scalars(
        TrainHParams(lr=3e-4, warmup_steps=2, total_steps=6),
        torch.tensor(2, dtype=torch.int32))), b1=0.9, b2=0.95, eps=1e-8)
    scale = torch.tensor(0.5)
    for dtype in (torch.float32, torch.bfloat16):
        arrs = [rng.normal(size=777).astype(np.float32) for _ in range(4)]
        arrs[3] = np.abs(arrs[3])
        a = [torch.from_numpy(x.copy()) for x in arrs]
        b = [torch.from_numpy(x.copy()) for x in arrs]
        for t in (a, b):
            t[0], t[1] = t[0].to(dtype), t[1].to(dtype)
        adamw_leaf(*a, scale, **kw)
        ref.adamw_leaf_ref(*b, scale, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _quant_input(seed=0, n_blocks=6):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n_blocks * BLOCK,)) * 3).astype(np.float32)
    x[:BLOCK] = 0.0                         # an all-zero block
    x[BLOCK + 5] = 40.0                     # an outlier
    return x, rng


def test_grad_quant_quantise_mode_bitwise_the_reference():
    """Quantise mode (the ring's per-hop ``_quant``) and ``_dequant``
    against the reference's, bit for bit, with an all-zero block and an
    outlier; ``x`` is left as it was."""
    x, _ = _quant_input()
    tx = torch.from_numpy(x.copy())
    q, s = grad_quant(tx)
    jq, js = j_gc._quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(gc._dequant(q, s).numpy(),
                                  np.asarray(j_gc._dequant(jq, js)))
    np.testing.assert_array_equal(tx.numpy(), x)
    gq, gs = gc._quant(torch.from_numpy(x.copy()))
    assert torch.equal(gq, q) and torch.equal(gs, s)


@pytest.fixture(scope="module")
def j_one_device():
    """The reference's ``compressed_allreduce_flat`` on a one-device axis."""
    return shard_map(
        lambda a, b: j_gc.compressed_allreduce_flat(a, b, "data"),
        mesh=jax.make_mesh((1,), ("data",)), in_specs=(P(), P()),
        out_specs=(P(), P()), check_vma=False)


@pytest.mark.parametrize("err_scale", [0.0, 1e-2])
def test_grad_quant_error_feedback_bitwise_the_reference(j_one_device,
                                                         err_scale):
    """Error-feedback mode in place against the reference's one-device
    ``compressed_allreduce_flat``, with a zero error buffer (a first step)
    and a carried one: Q(g + e) written over g, e' over e, bit for bit;
    and the quantise mode of g + e, the reference's ``_quant``."""
    g, rng = _quant_input(1)
    e = (rng.normal(size=g.shape) * err_scale).astype(np.float32)
    tq, ts = grad_quant(torch.from_numpy(g) + torch.from_numpy(e))
    jq, js = j_gc._quant(jnp.asarray(g) + jnp.asarray(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tg, te = torch.from_numpy(g.copy()), torch.from_numpy(e.copy())
    out = grad_quant(tg, te)
    assert len(out) == 2
    assert out[0].data_ptr() == tg.data_ptr()       # written in place
    assert out[1].data_ptr() == te.data_ptr()
    jred, jerr = j_one_device(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jred))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jerr))


def test_compressed_allreduce_one_device_bitwise_the_reference(j_one_device):
    """``compressed_allreduce_flat`` without a group runs the quantiser
    alone: the reference's one-device bits, carried over three steps of
    error feedback."""
    g, rng = _quant_input(2, n_blocks=9)
    e = np.zeros_like(g)
    te = torch.from_numpy(e.copy())
    je = jnp.asarray(e)
    for step in range(3):
        g = (g * 0.7 + rng.normal(size=g.shape)).astype(np.float32)
        red, te = gc.compressed_allreduce_flat(torch.from_numpy(g.copy()),
                                               te, None)
        jred, je = j_one_device(jnp.asarray(g), je)
        np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_grad_quant_empty_vector():
    """An empty vector: quantise mode gives empty payload and scales
    shaped as the reference's; error feedback returns empty vectors."""
    q, s = grad_quant(torch.zeros(0))
    jq, js = j_gc._quant(jnp.zeros((0,), jnp.float32))
    assert tuple(q.shape) == jq.shape == (0, BLOCK)
    assert tuple(s.shape) == js.shape == (0,)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    xq, err = grad_quant(torch.zeros(0), torch.zeros(0))
    assert xq.numel() == err.numel() == 0
    red, err = gc.compressed_allreduce_flat(torch.zeros(0), torch.zeros(0),
                                            None)
    assert red.numel() == err.numel() == 0


@pytest.mark.parametrize("n", [100, BLOCK + 1, 3 * BLOCK - 5])
def test_grad_quant_refuses_a_partial_block(n):
    """A length that is not a multiple of 256 raises, in both modes and
    through ``_quant`` and ``compressed_allreduce_flat``."""
    x = torch.ones(n)
    with pytest.raises(ValueError, match="multiple of 256"):
        grad_quant(x)
    with pytest.raises(ValueError, match="multiple of 256"):
        grad_quant(x, torch.zeros(n))
    with pytest.raises(ValueError, match="multiple of 256"):
        gc._quant(x)
    with pytest.raises(ValueError, match="multiple of 256"):
        gc.compressed_allreduce_flat(x, torch.zeros(n), None)
