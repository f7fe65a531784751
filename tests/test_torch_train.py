"""The port's training path against the reference's, on the CPU.

Data pipeline, optimizer, quantizer and checkpoints against the
reference's modules; ``LM.loss`` and its gradients on the f32 smoke
configs of qwen2.5-3b (tied embeddings), llama3-8b (untied), qwen3-8b
(qk-norm) and phi3-mini-3.8b against
``jax.value_and_grad`` of the reference's ``LM.loss``, from the same
weights (``bridge.params_from_jax`` of the reference's ``LM.init``); the
remat modes and gradient accumulation inside the port; and the port's
``Trainer`` on the CPU against the reference's.  Inputs are made with
numpy.  Tolerances, stated per test: 1e-6 for the optimizer (f32, other
fusion of the same operations), 1e-5 relative for a loss and 1e-4 of each
gradient's scale (f32, other summation order through 2 layers), bitwise
where the same code runs on the same numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainHParams as JHP
from repro.data import pipeline as j_pipe
from repro.launch.mesh import make_host_mesh
from repro.models.lm import LM as JLM
from repro.train import checkpoint as j_ckpt
from repro.train import grad_compress as j_gc
from repro.train import optimizer as j_opt
from repro.train.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.data import pipeline
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, make_train_step

ARCHS = ("qwen2.5-3b", "llama3-8b", "qwen3-8b", "phi3-mini-3.8b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions on tiny tensors: one intra-op thread, so that
    workers running side by side do not spin against each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _ref_params(arch, seed=0):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.PRNGKey(seed)))


def _port_lm(arch, jparams):
    lm = LM(_cfgs(arch)[1], master=True)
    lm.load_state_dict(params_from_jax(jparams))
    return lm


def _tokens(vocab, B=4, T=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, T)).astype(np.int32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


# ---------------------------------------------------------------- data


def test_pipeline_batches_bitwise_the_reference(tmp_path):
    for seed, step, rank in ((0, 0, 0), (1, 7, 0), (1, 7, 1), (5, 123, 3)):
        a = pipeline.SyntheticLM(97, 16, 4, seed=seed, rank=rank)
        b = j_pipe.SyntheticLM(97, 16, 4, seed=seed, rank=rank)
        np.testing.assert_array_equal(a.batch_at(step)["tokens"],
                                      b.batch_at(step)["tokens"])
        assert a.state(step) == b.state(step)
    path = str(tmp_path / "toks.bin")
    np.arange(1000, dtype=np.int32).tofile(path)
    for step in (0, 3, 40):
        np.testing.assert_array_equal(
            pipeline.MemmapCorpus(path, 10, 3, rank=1, num_ranks=2)
            .batch_at(step)["tokens"],
            j_pipe.MemmapCorpus(path, 10, 3, rank=1, num_ranks=2)
            .batch_at(step)["tokens"])
    src = pipeline.SyntheticLM(31, 8, 2, seed=0)
    pf = pipeline.Prefetcher(src, start_step=5, depth=2)
    try:
        got = [next(pf) for _ in range(3)]
    finally:
        pf.stop()
    assert [s for s, _ in got] == [5, 6, 7]
    for s, b in got:
        np.testing.assert_array_equal(
            b["tokens"], j_pipe.SyntheticLM(31, 8, 2, seed=0)
            .batch_at(s)["tokens"])


# ---------------------------------------------------------------- optim


def test_lr_schedule_at_the_references_points():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=2, total_steps=6),
               dict(lr=1e-3, warmup_steps=0, total_steps=1)):
        for step in (0, 1, 2, 5, 6, 10, 55, 90, 100, 150):
            got = float(opt.lr_schedule(TrainHParams(**kw), step))
            want = float(j_opt.lr_schedule(JHP(**kw), jnp.int32(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_adamw_update_matches_the_reference(clip):
    """Three AdamW steps on the same params, grads and moments; ``clip``
    0.05 makes every step clip.  1e-6 of each tensor's scale."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
              weight_decay=0.1)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = j_opt.adamw_init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    ts = opt.adamw_init(tp)
    for it in range(3):
        g = {n: rng.normal(size=s).astype(np.float32)
             for n, s in shapes.items()}
        jp, js, jm = j_opt.adamw_update(jp, {n: jnp.asarray(a)
                                             for n, a in g.items()}, js,
                                        JHP(**kw))
        tp, ts, tm = opt.adamw_update(
            tp, {n: torch.from_numpy(a.copy()) for n, a in g.items()}, ts,
            TrainHParams(**kw))
        assert int(ts["step"]) == int(js["step"]) == it + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        if clip < 1:
            assert float(tm["grad_norm"]) > clip
        for n in shapes:
            assert _rel(tp[n].numpy(), jp[n]) <= 1e-6
            assert _rel(ts["mu"][n].numpy(), js["mu"][n]) <= 1e-6
            assert _rel(ts["nu"][n].numpy(), js["nu"][n]) <= 1e-6


# ---------------------------------------------------------------- compress


def test_quant_and_pad_bitwise_the_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6 * gc.BLOCK,)) * 3).astype(np.float32)
    x[:gc.BLOCK] = 0.0                      # an all-zero block
    x[gc.BLOCK + 5] = 40.0                  # an outlier
    q, s = gc._quant(torch.from_numpy(x))
    jq, js = j_gc._quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(gc._dequant(q, s).numpy(),
                                  np.asarray(j_gc._dequant(jq, js)))
    y = rng.normal(size=(3, gc.BLOCK + 7)).astype(np.float32)
    padded, n = gc.pad_to_block(torch.from_numpy(y))
    jpadded, jn = j_gc.pad_to_block(jnp.asarray(y))
    assert n == jn
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    assert gc.padded_size(1000, 4) == j_gc.padded_size(1000, 4)
    # One rank: the ring is skipped, the mean is dequant(quant(g + e)) and
    # the error feedback the residual, bitwise the reference's on a
    # one-device axis (its test_compressed_allreduce_single_device_exact
    # input, then a vector with error feedback carried in).
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    fn = shard_map(lambda a, b: j_gc.compressed_allreduce_flat(a, b, "data"),
                   mesh=jax.make_mesh((1,), ("data",)), in_specs=(P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    g1 = np.linspace(-1, 1, gc.BLOCK).astype(np.float32)
    for g, e in ((g1, np.zeros_like(g1)),
                 (x, (rng.normal(size=x.shape) * 1e-2).astype(np.float32))):
        red, err = gc.compressed_allreduce_flat(torch.tensor(g),
                                                torch.tensor(e), None)
        jred, jerr = fn(jnp.asarray(g), jnp.asarray(e))
        np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        np.testing.assert_allclose((red + err).numpy(), g + e, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------- ckpt


def test_checkpoint_atomicity(tmp_path):
    import os
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones((2, 2))},
            "step": torch.tensor(3, dtype=torch.int32)}
    d = str(tmp_path)
    ckpt.save(d, 1, tree, extra={"data": {"step": 1}})
    # A torn write (no _COMPLETE marker) must be invisible to readers.
    os.makedirs(os.path.join(d, "step_00000002", "arrays"))
    with open(os.path.join(d, "step_00000002", "meta.json"), "w") as f:
        f.write("{}")
    assert ckpt.latest_step(d) == 1
    restored, extra = ckpt.restore(d, 1, tree)
    assert extra == {"data": {"step": 1}}
    for path in (("w",), ("b", "x"), ("step",)):
        a, b = tree, restored
        for key in path:
            a, b = a[key], b[key]
        assert a.dtype == b.dtype and torch.equal(a, b)
    # The reference's reader restores the port's layout.
    jtree, _ = j_ckpt.restore(d, 1, {"w": jnp.zeros(8), "b": {
        "x": jnp.zeros((2, 2))}, "step": jnp.int32(0)})
    np.testing.assert_array_equal(np.asarray(jtree["w"]), np.arange(8.0))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, {"w": torch.zeros((5,))})
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(d, 1, {"other": torch.zeros((4,))})


def test_checkpoint_prune_keeps_newest(tmp_path):
    import os
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, {"w": torch.zeros((2,))})
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000004", "step_00000005"]


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """The loss at 1e-5 relative, every parameter's gradient at 1e-4 of its
    scale; the tied config has no ``unembed``, the untied one has."""
    jparams = _ref_params(arch)
    jcfg, cfg = _cfgs(arch)
    toks = _tokens(cfg.vocab_size)
    jlm = JLM(jcfg)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)}, remat=True),
        has_aux=True)(jparams)
    lm = _port_lm(arch, jparams)
    loss, aux = lm.loss({"tokens": toks})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["nll"].detach()) == pytest.approx(float(jaux["nll"]),
                                                       rel=1e-5)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    assert float(aux["tokens"]) == float(jaux["tokens"]) == toks.size - 4
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in lm.named_parameters()}
    assert set(got) == set(want)
    assert ("unembed" in got) == (not cfg.tie_embeddings)
    for n, g in got.items():
        assert _rel(g.numpy(), want[n].numpy()) <= 1e-4, n


def _grads(lm, toks, remat):
    lm.zero_grad(set_to_none=True)
    lm.loss({"tokens": toks}, remat=remat)[0].backward()
    return {n: p.grad.clone() for n, p in lm.named_parameters()}


def test_remat_modes_give_the_same_gradients_bitwise():
    arch = "qwen2.5-3b"
    lm = _port_lm(arch, _ref_params(arch))
    toks = _tokens(lm.cfg.vocab_size)
    base = _grads(lm, toks, False)
    for remat in ("none", True, "block", "save_collectives"):
        got = _grads(lm, toks, remat)
        for n in base:
            assert torch.equal(got[n], base[n]), (remat, n)
    with pytest.raises(ValueError, match="remat"):
        lm.loss({"tokens": toks}, remat="all")


def test_microbatch_two_matches_full_batch():
    """One optimizer step with 2 sequential microbatches against the full
    batch: the averaged f32 grads differ by summation order only (loss
    1e-6 relative; params after the step 1e-5 of their scale)."""
    arch = "llama3-8b"
    jparams = _ref_params(arch)
    toks = _tokens(_cfgs(arch)[1].vocab_size)
    runs = []
    for micro in (0, 2):
        hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=10,
                          microbatch=micro, remat="none")
        lm = _port_lm(arch, jparams)
        state = opt.adamw_init(dict(lm.named_parameters()))
        _, m = make_train_step(lm, hp)(state, {"tokens": toks})
        runs.append((m, {n: p.detach().clone()
                         for n, p in lm.named_parameters()}))
    (m0, p0), (m1, p1) = runs
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m0["grad_norm"]),
                                                   rel=1e-5)
    for n in p0:
        assert _rel(p1[n].numpy(), p0[n].numpy()) <= 1e-5, n


# ---------------------------------------------------------------- trainer


HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="none", grad_compress=False)


def _trainer(tmp, jparams, **kw):
    _, cfg = _cfgs("qwen2.5-3b")
    return Trainer(cfg, TrainHParams(**HP), batch_per_step=4, seq_len=32,
                   ckpt_dir=str(tmp), ckpt_every=kw.pop("ckpt_every", 3),
                   device="cpu", params=params_from_jax(jparams), **kw)


def test_trainer_on_cpu_loss_falls_and_matches_the_reference(tmp_path):
    """12 steps: the loss falls; the first three steps' losses are within
    1e-4 relative of the reference Trainer's on the same weights and data."""
    jparams = _ref_params("qwen2.5-3b")
    tr = _trainer(tmp_path / "p", jparams, ckpt_every=0)
    hist = tr.run(12, log_every=1)
    assert [s for s, _ in hist] == list(range(1, 13))
    assert all(np.isfinite(l) for _, l in hist)
    assert hist[-1][1] < hist[0][1], hist
    assert len(tr.log) == 12 and all(r["ms"] > 0 for r in tr.log)
    jcfg, _ = _cfgs("qwen2.5-3b")
    jtr = JTrainer(jcfg, JHP(**HP), make_host_mesh(), batch_per_step=4,
                   seq_len=32, ckpt_dir=str(tmp_path / "j"), ckpt_every=0)
    jhist = jtr.run(3, log_every=1)
    for (s, got), (js, want) in zip(hist[:3], jhist):
        assert s == js
        assert got == pytest.approx(want, rel=1e-4)


def test_trainer_checkpoint_restart_bit_identical(tmp_path):
    """Stop after step 6, restart from its checkpoint: the parameters and
    Adam moments after 3 more steps equal an uninterrupted 9-step run's bit
    for bit (the data pipeline is stateless)."""
    jparams = _ref_params("qwen2.5-3b")
    tr1 = _trainer(tmp_path / "a", jparams)
    tr1.run(9, log_every=100)
    tr2 = _trainer(tmp_path / "b", jparams)
    tr2.run(6, log_every=100)
    del tr2
    tr3 = _trainer(tmp_path / "b", jparams, resume=True)
    assert tr3.start_step == 6 and int(tr3.opt["step"]) == 6
    tr3.run(3, log_every=100)
    assert int(tr3.opt["step"]) == int(tr1.opt["step"]) == 9
    for n, p in tr1.params.items():
        assert torch.equal(p, tr3.params[n]), n
        assert torch.equal(tr1.opt["mu"][n], tr3.opt["mu"][n]), n
        assert torch.equal(tr1.opt["nu"][n], tr3.opt["nu"][n]), n


def test_trainer_refuses_multi_device_features():
    """A mesh with a ``model`` axis > 1 (tensor parallelism, megatron by
    default) needs a process group of its size: without one it raises.
    ``grad_compress`` and fsdp run on one device, as the reference's
    Trainer runs them on its one-device host mesh: the first three losses
    within 1e-4 relative of the reference's.  Without a card, the default
    device raises."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, TrainHParams(), 2, 16, device="cpu",
                mesh=Mesh((1, 2), ("data", "model")))
    jparams = _ref_params("qwen2.5-3b")
    for kw in (dict(grad_compress=True), dict(parallelism="fsdp")):
        tr = Trainer(cfg, TrainHParams(**{**HP, **kw}), batch_per_step=4,
                     seq_len=32, ckpt_every=0, device="cpu",
                     params=params_from_jax(jparams))
        hist = tr.run(3, log_every=1)
        jtr = JTrainer(jcfg, JHP(**{**HP, **kw}), make_host_mesh(),
                       batch_per_step=4, seq_len=32, ckpt_every=0)
        jhist = jtr.run(3, log_every=1)
        assert [s for s, _ in hist] == [s for s, _ in jhist] == [1, 2, 3]
        for (_, got), (_, want) in zip(hist, jhist):
            assert got == pytest.approx(want, rel=1e-4), kw
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, TrainHParams(), 2, 16)


def test_chip_smoke_phase_9c_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 9c with the 'card' run on the CPU: the narrow
    model's losses agree and its checkpoint-resume is bitwise."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    chip_smoke.train_agreement("cpu")
