"""Training of the vlm, encdec, ssm and hybrid families: port vs reference.

``LM.loss`` and every parameter's gradient on the f32 smoke configs of
llava-next-mistral-7b (vlm: random image embeddings in front of the
tokens), seamless-m4t-large-v2 (encdec: random source frames),
mamba2-1.3b (ssm) and zamba2-1.2b (hybrid) against
``jax.value_and_grad`` of the reference's ``LM.loss``, from the same
weights (``bridge.params_from_jax`` of the reference's ``LM.init``) and
the same numpy inputs: the loss within 1e-5 relative and each gradient
within 1e-4 of its scale (f32, other summation order through a few
layers), as tests/test_torch_train.py holds the dense family.  Then what
the port keeps of the reference's behaviour (remat changes no value; the
hybrid stack recomputes nothing whatever ``remat`` says, in both
packages), ``make_train_step``'s microbatches carrying every batch key,
and the launcher's refusal of the families whose batches ``SyntheticLM``
cannot make.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models.lm import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import make_train_step
from test_torch_parity_helpers import frontend_batch

ARCHS = ("llava-next-mistral-7b", "seamless-m4t-large-v2", "mamba2-1.3b",
         "zamba2-1.2b")


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


def _batch(arch, B=2, T=64, seed=0):
    """Tokens (T = 64: two of the smoke configs' 32-row SSD chunks, so the
    carried state crosses a chunk) and the family's frontend embeddings."""
    cfg = _cfgs(arch)[1]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return frontend_batch(cfg, toks, seed=seed + 7)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """The loss at 1e-5 relative, every parameter's gradient (``frontend_
    proj`` included for vlm and encdec; the shared block's summed over its
    invocations for hybrid) at 1e-4 of its scale."""
    jcfg, cfg = _cfgs(arch)
    batch = _batch(arch)
    jlm = JLM(jcfg)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jlm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           remat=True), has_aux=True)(_ref_params(arch))
    lm = _port_lm(arch)
    loss, aux = lm.loss(batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(aux["nll"].detach()) == pytest.approx(float(jaux["nll"]),
                                                       rel=1e-5)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    tokens = batch["tokens"]
    assert float(aux["tokens"]) == float(jaux["tokens"]) == \
        tokens.shape[0] * (tokens.shape[1] - 1)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in lm.named_parameters()}
    assert set(got) == set(want)
    assert ("frontend_proj" in got) == (cfg.family in ("vlm", "encdec"))
    for n, g in got.items():
        assert _rel(g.numpy(), want[n].numpy()) <= 1e-4, n


def _grads(lm, batch, remat):
    lm.zero_grad(set_to_none=True)
    lm.loss(batch, remat=remat)[0].backward()
    return {n: p.grad.clone() for n, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_gradients_bitwise(arch):
    """Recomputation changes no bit: every remat mode's gradients equal
    the no-remat run's."""
    lm = _port_lm(arch)
    batch = _batch(arch, T=32)
    base = _grads(lm, batch, False)
    for remat in ("none", True, "block", "save_collectives"):
        got = _grads(lm, batch, remat)
        for n in base:
            assert torch.equal(got[n], base[n]), (remat, n)


def _count_scans(monkeypatch):
    """Counts the SSD scan's forward calls (serving call or SSDScanFn's
    forward, recomputations included)."""
    calls = []
    inner = ssd_mod._scan

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(ssd_mod, "_scan", counted)
    return calls


def _reference_remats(arch, remat):
    """Whether the reference's differentiated loss holds a remat
    (``jax.checkpoint``) anywhere in its jaxpr."""
    jcfg, _ = _cfgs(arch)
    jlm = JLM(jcfg)
    toks = jnp.asarray(_batch(arch, T=32)["tokens"])
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: jlm.loss(p, {"tokens": toks}, remat=remat)[0]))(
            _ref_params(arch))
    return "remat" in str(jaxpr) or "checkpoint" in str(jaxpr)


def test_hybrid_never_recomputes_in_either_package(monkeypatch):
    """The reference's ``LM.loss`` passes no ``remat`` to its hybrid stack:
    with remat on, its differentiated loss holds a remat for mamba2 and
    none for zamba2.  The port keeps that: a loss and backward with remat
    on runs each Mamba-2 layer's scan twice for mamba2 (the recompute) and
    once for zamba2."""
    assert _reference_remats("mamba2-1.3b", True)
    assert not _reference_remats("mamba2-1.3b", False)
    assert not _reference_remats("zamba2-1.2b", True)
    for arch, per_layer in (("mamba2-1.3b", 2), ("zamba2-1.2b", 1)):
        lm = _port_lm(arch)
        calls = _count_scans(monkeypatch)
        lm.loss(_batch(arch, T=32), remat=True)[0].backward()
        assert len(calls) == per_layer * lm.cfg.n_layers, arch
        monkeypatch.undo()


@pytest.mark.parametrize("remat", [True, "none"])
def test_encdec_training_flash_calls_name_their_site(monkeypatch, remat):
    """seamless's differentiated flash calls pass their site to both
    training kernels, so that the card counts them by site: per encoder
    layer one ``encoder`` call, per decoder layer one ``cross_prefill``
    call and one self-attention call with no site; each forward twice
    under remat (the recompute), each backward once."""
    from repro_torch.kernels import flash_attention as fa
    seen = {"fwd": [], "bwd": []}
    for key, name in (("fwd", "flash_attention_lse"),
                      ("bwd", "flash_attention_bwd")):
        inner = getattr(fa, name)

        def counted(*a, _inner=inner, _key=key, site=None, **kw):
            seen[_key].append(site)
            return _inner(*a, site=site, **kw)
        monkeypatch.setattr(fa, name, counted)
    lm = _port_lm("seamless-m4t-large-v2")
    lm.loss(_batch("seamless-m4t-large-v2", T=32), remat=remat)[0].backward()
    e = lm.cfg.encdec
    k = 2 if remat is True else 1
    for key, n in (("fwd", k), ("bwd", 1)):
        assert sorted(seen[key], key=str) == sorted(
            ["encoder"] * n * e.enc_layers
            + ["cross_prefill"] * n * e.dec_layers
            + [None] * n * e.dec_layers, key=str), key


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_microbatch_two_matches_full_batch(arch):
    """``make_train_step`` cuts every batch key along dim 0, as the
    reference's ``_accum_grads``: a step with 2 microbatches over batches
    with frontend embeddings equals the full batch's (loss 1e-6 relative,
    grad norm 1e-5, params after the step 1e-5 of their scale, as
    tests/test_torch_train.py's dense test)."""
    batch = _batch(arch, B=4, T=24)
    runs = []
    for micro in (0, 2):
        hp = TrainHParams(lr=1e-3, warmup_steps=1, total_steps=10,
                          microbatch=micro, remat="none")
        lm = _port_lm(arch)
        state = opt.adamw_init(dict(lm.named_parameters()))
        _, m = make_train_step(lm, hp)(state, batch)
        runs.append((m, {n: p.detach().clone()
                         for n, p in lm.named_parameters()}))
    (m0, p0), (m1, p1) = runs
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    assert float(m1["grad_norm"]) == pytest.approx(float(m0["grad_norm"]),
                                                   rel=1e-5)
    for n in p0:
        assert _rel(p1[n].numpy(), p0[n].numpy()) <= 1e-5, n


@pytest.mark.parametrize("arch,key", [("llava-next-mistral-7b",
                                       "patch_embeds"),
                                      ("seamless-m4t-large-v2",
                                       "src_embeds")])
def test_launcher_refuses_families_with_frontend_embeddings(arch, key):
    """``launch/train.py`` draws tokens only: it names the embeddings the
    family's loss needs and refuses."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match=key):
        main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1"])
