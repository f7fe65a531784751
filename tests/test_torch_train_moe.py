"""Training of the moe family (deepseek-v2-lite's MLA and MoE layers, dbrx's
MoE layers): port vs reference.

``LM.loss`` and every parameter's gradient on the f32 smoke configs of
deepseek-v2-lite-16b (MLA attention at key width 16 + 8 = 24 and value
width 16, a dense first layer, 4 routed experts top-2 + 1 shared) and
dbrx-132b (GQA, 4 experts top-2) against ``jax.value_and_grad`` of the
reference's ``LM.loss``, from the same weights (``bridge.params_from_jax``
of the reference's ``LM.init``) and the same numpy tokens: the loss, its
NLL and the summed load-balance aux within 1e-5 relative and each gradient
within 1e-4 of its scale (f32, other summation order through a few
layers), as tests/test_torch_train_families.py holds the other families.
Then the blocks on their own against ``jax.grad`` of the reference's
(``moe_block`` with entries dropped past the capacity, its aux loss in the
objective, so that the router's gradient through ``me`` is checked;
``mla_block_train``), the three remat modes, the port's ``Trainer``
against the reference's, and chip_smoke.py's phases 9c, 9h and 9i
rehearsed on the CPU at smoke width.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import TrainHParams as JHP
from repro.launch.mesh import make_host_mesh
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.lm import LM as JLM
from repro.train.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM
from repro_torch.train.trainer import Trainer

ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="block", grad_compress=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Plain versions on tiny tensors: one intra-op thread, so that
    workers running side by side do not spin against each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _cfgs(arch, **moe_kw):
    """(reference cfg, port cfg): ``arch``'s smoke config in f32, with MoE
    fields overridden by ``moe_kw``."""
    out = []
    for smoke in (j_smoke, get_smoke_config):
        cfg = dataclasses.replace(smoke(arch), dtype="float32")
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


_PARAMS = {}


def _ref_params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = jax.tree.map(
            np.asarray, JLM(_cfgs(arch)[0]).init(jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def _port_lm(arch):
    lm = LM(_cfgs(arch)[1], master=True)
    lm.load_state_dict(params_from_jax(_ref_params(arch)))
    return lm


def _tokens(vocab, B=2, T=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _layer(tree, group, l=0):
    """Layer ``l`` of the reference's stacked ``decoder`` weights of
    ``group`` (``moe``, ``attn``) as numpy arrays."""
    return {k: np.array(v[l]) for k, v in tree["decoder"][group].items()}


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """The loss, NLL and aux at 1e-5 relative, every parameter's gradient
    (deepseek's ``decoder_prefix`` and MLA weights, both models' routers,
    experts and shared experts) at 1e-4 of its scale."""
    jcfg, cfg = _cfgs(arch)
    toks = _tokens(cfg.vocab_size)
    jlm = JLM(jcfg)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)}, remat=True),
        has_aux=True)(_ref_params(arch))
    lm = _port_lm(arch)
    loss, aux = lm.loss({"tokens": toks})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["nll"].detach()) == pytest.approx(float(jaux["nll"]),
                                                       rel=1e-5)
    assert float(aux["aux"].detach()) > 0
    assert float(aux["aux"].detach()) == pytest.approx(float(jaux["aux"]),
                                                       rel=1e-5)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == toks.shape[0] * (
        toks.shape[1] - 1)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in lm.named_parameters()}
    assert set(got) == set(want)
    assert ("decoder_prefix.attn.w_uk" in got) == (cfg.mla is not None)
    assert "decoder.moe.router" in got
    for n, g in got.items():
        assert _rel(g.numpy(), want[n].numpy()) <= 1e-4, n


def _grads(lm, toks, remat):
    lm.zero_grad(set_to_none=True)
    total, aux = lm.loss({"tokens": toks}, remat=remat)
    total.backward()
    return total.detach(), aux["aux"], {n: p.grad.clone()
                                        for n, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_values_bitwise(arch):
    """No recomputation, per-layer ("block") and per-block
    ("save_collectives"): the same loss, aux and gradients bit for bit; a
    MoE layer's recompute routes as its forward did."""
    lm = _port_lm(arch)
    toks = _tokens(lm.cfg.vocab_size, seed=3)
    base = _grads(lm, toks, False)
    for remat in ("none", True, "block", "save_collectives"):
        total, aux, grads = _grads(lm, toks, remat)
        assert torch.equal(total, base[0]) and torch.equal(aux, base[1])
        for n in base[2]:
            assert torch.equal(grads[n], base[2][n]), (remat, n)


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("arch,cf", [("deepseek-v2-lite-16b", 0.75),
                                     ("dbrx-132b", 0.5)])
def test_moe_block_grad_with_drops_matches_jax(arch, cf):
    """``moe_block``'s gradients (input, router, experts, shared experts)
    of <y, dy> + 0.1 aux against ``jax.grad`` of the reference's at a
    capacity factor that drops entries: the gates carry the router's
    gradient through the top-k values, the aux through ``me`` (``fe``
    counts choices and has none), the dropped entries nothing."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    p = _layer(_ref_params(arch), "moe")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def j_obj(p, x):
        y, aux = jmoe.moe_block(jcfg, p, x)
        return jnp.sum(y * dy) + 0.1 * aux

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_block(tcfg, tp, tx)
    (torch.sum(y * torch.from_numpy(dy)) + 0.1 * aux).backward()
    keep = tmoe.route(tcfg, tp["router"].detach(), tx.detach())[4]
    assert bool((~keep).any()), "the capacity factor must drop entries"
    assert _rel(tx.grad.numpy(), np.asarray(jg_x)) <= 1e-5
    for k, g in tp.items():
        assert _rel(g.grad.numpy(), np.asarray(jg_p[k])) <= 1e-5, k


def test_mla_block_train_grad_matches_jax():
    """``mla_block_train`` (expanded attention, key width 24 and value width
    16 through the flash autograd function) against ``jax.grad`` of the
    reference's: the input's and every MLA weight's gradient of <out,
    dout>; k_rope's gradient sums over the heads its expand fed."""
    arch = "deepseek-v2-lite-16b"
    jcfg, tcfg = _cfgs(arch)
    p = _layer(_ref_params(arch), "attn")
    rng = np.random.default_rng(7)
    B, T = 2, 40
    x = rng.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    dout = rng.normal(size=x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T))

    def j_obj(p, x):
        out, _ = jmla.mla_block_train(jcfg, p, x, jnp.asarray(pos))
        return jnp.sum(out * dout)

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, payload = tmla.mla_block_train(tcfg, tp, tx, torch.from_numpy(
        np.ascontiguousarray(pos)))
    (out * torch.from_numpy(dout)).sum().backward()
    m = tcfg.mla
    assert payload["k"].shape == (B, T, 1, m.kv_lora_rank
                                  + m.qk_rope_head_dim)
    assert _rel(tx.grad.numpy(), np.asarray(jg_x)) <= 1e-5
    for k, g in tp.items():
        assert _rel(g.grad.numpy(), np.asarray(jg_p[k])) <= 1e-5, k


# ------------------------------------------------------------------ trainer


def test_trainer_on_cpu_matches_the_reference(tmp_path):
    """Three steps of the port's Trainer and the reference's on
    deepseek-v2-lite's smoke config, same weights and data: every loss
    within 1e-4 relative, all finite, the logged aux above 0."""
    arch = "deepseek-v2-lite-16b"
    jcfg, cfg = _cfgs(arch)
    tr = Trainer(cfg, TrainHParams(**HP), batch_per_step=2, seq_len=64,
                 ckpt_dir=str(tmp_path / "p"), ckpt_every=0, device="cpu",
                 params=params_from_jax(_ref_params(arch)))
    hist = tr.run(3, log_every=1)
    jtr = JTrainer(jcfg, JHP(**HP), make_host_mesh(), batch_per_step=2,
                   seq_len=64, ckpt_dir=str(tmp_path / "j"), ckpt_every=0)
    jhist = jtr.run(3, log_every=1)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [1, 2, 3]
    for (_, got), (_, want) in zip(hist, jhist):
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-4)
    assert all(r["aux"] > 0 for r in tr.log)


# ------------------------------------------------------------------ chip_smoke


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_phase_9h_rehearsed_on_the_cpu(chip_smoke, arch):
    """Phase 9h for the moe family at smoke width in f32, the card's run on
    the CPU: the CPU run replays the first run's expert choices (forward
    and recompute), and the losses agree."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    chip_smoke.family_train_agreement(arch, "cpu", steps=2, cfg=cfg)


def test_chip_smoke_phase_9i_rehearsed_on_the_cpu(chip_smoke):
    """Phase 9i at smoke width (bf16 compute, remat block), the card's run
    on the CPU: three steps, finite, aux above 0, the last batch's loss
    falls after its update."""
    counts = chip_smoke.phase_train_moe(
        "cpu", get_smoke_config("deepseek-v2-lite-16b"), B=2, T=64)
    assert not any(counts.values())


def test_chip_smoke_phase_9c_resume_rehearsed_on_the_cpu(chip_smoke):
    """Phase 9c's checkpoint-resume of the narrow deepseek-v2-lite (MLA at
    192 / 128, 64 experts): parameters and Adam moments bit for bit the
    uninterrupted run's."""
    chip_smoke.train_agreement("cpu", "deepseek-v2-lite-16b",
                               against_cpu=False)


def test_chip_smoke_moe_launches_and_entries(chip_smoke):
    """Phase 9i's launches at full width (per step 2 flash forwards and 1
    backward for each of the 5 MLA layers, the dense one included) become
    the ``.mla`` entries; dbrx's ``.moe`` entries have none, with a reason;
    the kernel shapes are MLA's and dbrx's."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=chip_smoke.MOE_TRAIN_LAYERS)
    counts = chip_smoke.train_launches(cfg, 3)
    assert counts["flash_attention.train"] == 30
    assert counts["flash_attention_bwd"] == 15
    assert chip_smoke.moe_entries(counts) == {
        "flash_attention.train.mla": 30, "flash_attention_bwd.mla": 15,
        "flash_attention.train.moe": 0, "flash_attention_bwd.moe": 0}
    assert set(chip_smoke.ZERO_LAUNCHES) == {"flash_attention.train.moe",
                                             "flash_attention_bwd.moe"}
    shapes = {s[0]: s[5:9] for s in chip_smoke.MOE_FLASH_SHAPES}
    assert shapes == {"mla": (16, 16, 192, 128), "moe": (48, 8, 128, 128)}
