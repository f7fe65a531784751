"""The port's tensor- and expert-parallel training over gloo ranks against
the reference on forced host devices, on the CPU.

A mesh's ``model`` axis > 1 under megatron runs the reference's explicit
blocks (Megatron attention, TP SwiGLU, the MoE training EP) on each rank's
model shards; ``auto`` gathers every ``model``-split leaf instead.  The
port runs on 2 and 4 ranks, each its own process
(``repro_torch.launch.spawn.run_ranks``; rank functions in
``tests/torch_dist_cases.py``).  The reference runs once, in its own
process on 4 forced host devices, every case of this file in it, on the
same mesh shapes, while the port's ranks run.  Both start from the
reference's ``LM.init`` at seed 0 (the port through the bridge).

Tolerances, stated per test: losses 1e-4 relative of the reference's (the
standing training gate); the port's (data, model)-rank run within 1e-6 of
its own single-device run (losses and grad norms relative, each leaf's
first mean gradient of the whole gradient's largest element: the blocks
sum the same f32 terms in another order); the int8 ring at its 1e-6
(``tests/test_torch_train_dist.py``); resumes and restores bitwise.
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import list_archs
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.launch.elastic import elastic_restart_plan
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.transformer import tp_geometry
from repro_torch.train import grad_compress as gc
from repro_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
QWEN = "qwen2.5-3b"
# (1, 2) cases: name -> (arch, hp overrides).  The MoE ones are held to
# the reference's one-device run: its training EP is at fault (EP_FAULT).
PAIR = {"auto": (QWEN, {"parallelism": "auto"}),
        "qwen3": ("qwen3-8b", {}), "dbrx": ("dbrx-132b", {}),
        "deepseek": ("deepseek-v2-lite-16b", {}),
        "zamba2": ("zamba2-1.2b", {}), "mamba2": ("mamba2-1.3b", {})}
EP_FAULT = ("dbrx", "deepseek")
ENCDEC = "seamless-m4t-large-v2"
ARCHS = sorted({QWEN, ENCDEC, *(a for a, _ in PAIR.values())})
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="none", grad_compress=False)
sys.path.insert(0, TESTS)
try:
    from torch_reference_run import WAIT_SECONDS as TIMEOUT
    from torch_reference_run import ReferenceRun
finally:
    sys.path.remove(TESTS)

# The reference on 4 forced host devices: its Trainer on the port's mesh
# shapes (3 steps each), seamless through make_train_step on batches with
# source frames, per-leaf gradients at (1, 2) against its own one-device
# gradients, and a grad_compress run at D = 2 resumed from its step-2
# checkpoint.
_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs import get_smoke_config
from repro.configs.base import TrainHParams
from repro.data.pipeline import SyntheticLM
from repro.models.lm import LM
from repro.train.trainer import Trainer, configure_parallelism, make_train_step

out_dir, hp, pair = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
devs = np.array(jax.devices())
assert len(devs) == 4, devs
out = {}

def mesh_of(shape):
    return Mesh(devs[:int(np.prod(shape))].reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)

def cfg_of(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")

def trainer(arch, shape, **kw):
    return Trainer(cfg_of(arch), TrainHParams(**{**hp, **kw}), mesh_of(shape),
                   batch_per_step=4, seq_len=32, ckpt_every=0)

def steps(tr, n, start=0):
    rec = {"loss": [], "aux": []}
    with compat.set_mesh(tr.mesh):
        for i in range(start, start + n):
            batch = {k: jax.device_put(v, tr._bs)
                     for k, v in tr.data.batch_at(i).items()}
            tr.params, tr.opt, tr.ef, m = tr.step_fn(tr.params, tr.opt,
                                                     tr.ef, batch)
            rec["loss"].append(float(m["loss"]))
            rec["aux"].append(float(m["aux"]))
    return rec

for shape in ((1, 2), (2, 2), (1, 4)):
    out[f"qwen{shape[0]}{shape[1]}"] = steps(trainer("qwen2.5-3b", shape), 3)
for name, (arch, kw) in pair.items():
    out[name] = steps(trainer(arch, (1, 2), **kw), 3)

def frames(cfg, i):
    return np.random.default_rng([0, i]).standard_normal(
        (4, cfg.encdec.source_len, cfg.d_model), dtype=np.float32)

cfg = cfg_of("seamless-m4t-large-v2")
lm, mesh = LM(cfg), mesh_of((1, 2))
step_fn, init_fn = make_train_step(lm, TrainHParams(**hp), mesh)
with compat.set_mesh(mesh):
    params, opt, ef = init_fn(jax.random.PRNGKey(0))
    fn = jax.jit(step_fn)
    data, rec = SyntheticLM(cfg.vocab_size, 32, 4, seed=0), {"loss": []}
    for i in range(3):
        batch = dict(data.batch_at(i), src_embeds=frames(cfg, i))
        params, opt, ef, m = fn(params, opt, ef, batch)
        rec["loss"].append(float(m["loss"]))
out["seamless"] = rec

# Per-leaf gradients of the first batch's loss under the explicit blocks at
# (1, 2) against the same on one device (qwen3's qk-norm, dbrx's router):
# the reference's shard_map runs with check_vma=False, so its transposition
# is checked before it is trusted; and the MoE models' one-device losses.
configure_parallelism(TrainHParams(**hp))
out["leaf_grads"], out["one_device_loss"] = {}, {}
for arch in ("qwen3-8b", "dbrx-132b", "deepseek-v2-lite-16b"):
    lm = LM(cfg_of(arch))
    params = lm.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(lm.cfg.vocab_size, 32, 4, seed=0).batch_at(0)
    def loss(p):
        return lm.loss(p, batch, remat=False)[0]
    if arch == "deepseek-v2-lite-16b":
        out["one_device_loss"][arch] = float(jax.jit(loss)(params))
        continue
    val, one = jax.jit(jax.value_and_grad(loss))(params)
    out["one_device_loss"][arch] = float(val)
    with compat.set_mesh(mesh_of((1, 2))):    # traced anew under the mesh
        two = jax.jit(jax.grad(loss))(params)
    flat1 = jax.tree_util.tree_flatten_with_path(one)[0]
    flat2 = jax.tree.leaves(two)
    scale = max(float(np.abs(g).max()) for _, g in flat1)
    out["leaf_grads"][arch] = {
        ".".join(str(getattr(k, "key", k)) for k in path):
        float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale
        for (path, a), b in zip(flat1, flat2)}

# grad_compress at (2, 1): 4 steps checkpointing at 2, then resumed.
d = f"{out_dir}/ref_ckpt"
tr = Trainer(cfg_of("qwen2.5-3b"), TrainHParams(**{**hp, "grad_compress": True}),
             mesh_of((2, 1)), batch_per_step=4, seq_len=32, ckpt_dir=d,
             ckpt_every=2)
straight = steps(tr, 2)
tr.save(2)
straight_rest = steps(tr, 2, start=2)
ef_before = max(float(np.abs(np.asarray(e)).max())
                for e in jax.tree.leaves(tr.ef))
tr2 = Trainer(cfg_of("qwen2.5-3b"), TrainHParams(**{**hp, "grad_compress": True}),
              mesh_of((2, 1)), batch_per_step=4, seq_len=32, ckpt_dir=d,
              ckpt_every=0, resume=True)
ef_resumed = max(float(np.abs(np.asarray(e)).max())
                 for e in jax.tree.leaves(tr2.ef))
tr2.step_fn = tr.step_fn        # the same step, compiled once
out["compress_resume"] = {
    "straight": straight["loss"] + straight_rest["loss"],
    "start": tr2.start_step, "resumed": steps(tr2, 2, start=2)["loss"],
    "ef_max_straight": ef_before, "ef_max_at_resume": ef_resumed}
with open(f"{out_dir}/ref.json", "w") as f:
    json.dump(out, f)
"""


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _close(got, want, rel):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=rel), (got, want)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights of every arch, and the reference's process, started here so
    that it runs while the port's ranks do."""
    d = tmp_path_factory.mktemp("tp")
    paths = {}
    for arch in ARCHS:
        jp = jax.tree.map(np.asarray, JLM(_f32(j_smoke(arch))).init(
            jax.random.PRNGKey(0)))
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(params_from_jax(jp), paths[arch])
    # At the backend's optimisation level 0 (torch_reference_run.XLA_FAST)
    # the reference's losses move by ~2e-7 relative, far inside this
    # file's 1e-4 gate.
    ref = ReferenceRun(_REFERENCE, [
        d, json.dumps({k: v for k, v in HP.items() if k != "grad_compress"}),
        json.dumps(PAIR)], d)
    yield types.SimpleNamespace(dir=d, params=paths, ref=ref)
    ref.close()


@pytest.fixture(scope="module")
def reference(setup):
    setup.ref.wait()
    with open(setup.dir / "ref.json") as f:
        return json.load(f)


def _spec(setup, arch, mesh, **kw):
    return dict(arch=arch, mesh=list(mesh), params=setup.params[arch], **kw)


def _ranks(world, cases):
    return run_ranks("torch_dist_cases:suite", world, args=[cases],
                     paths=[TESTS], timeout=TIMEOUT)


@pytest.fixture(scope="module")
def ranks4(setup):
    d = setup.dir
    return _ranks(4, {
        "tp22": ("train_and_resume", _spec(setup, QWEN, (2, 2),
                                           ckpt_dir=str(d / "tp22"))),
        "tp14": ("train", _spec(setup, QWEN, (1, 4), steps=4, ckpt_every=2,
                                ckpt_dir=str(d / "tp14"))),
        # (1, 4)'s step-4 checkpoint onto (2, 2).
        "reshard14": ("restored", _spec(setup, QWEN, (2, 2),
                                        ckpt_dir=str(d / "tp14"))),
        "plain22": ("train", _spec(setup, QWEN, (2, 2), steps=3)),
        "compress22": ("train", _spec(setup, QWEN, (2, 2), steps=3,
                                      ring=True,
                                      hp=dict(grad_compress=True))),
        "save_collectives": ("train", _spec(
            setup, QWEN, (2, 2), steps=1, hp=dict(remat="save_collectives"))),
        "block": ("train", _spec(setup, QWEN, (2, 2), steps=1,
                                 hp=dict(remat="block"))),
    })


@pytest.fixture(scope="module")
def ranks2(setup, ranks4):
    d = setup.dir
    cases = {name: ("train", _spec(setup, arch, (1, 2), steps=4, hp=hp))
             for name, (arch, hp) in PAIR.items()}
    # The elastic restart of (1, 4)'s run on 2 surviving ranks.
    shape, _ = elastic_restart_plan(2, model_axis=4)
    cases.update({
        "reshard14_elastic": ("restored", _spec(setup, QWEN, shape,
                                                ckpt_dir=str(d / "tp14"))),
        "tp12": ("train", _spec(setup, QWEN, (1, 2), steps=4, ckpt_every=2,
                                ckpt_dir=str(d / "tp12"))),
        "reshard12": ("restored", _spec(setup, QWEN, (2, 1),
                                        ckpt_dir=str(d / "tp12"))),
        "seamless": ("train_batches", _spec(setup, ENCDEC, (1, 2), steps=3)),
        "compress_resume": ("train_and_resume", _spec(
            setup, QWEN, (2, 1), hp=dict(grad_compress=True),
            ckpt_dir=str(d / "compress21"))),
    })
    return _ranks(2, cases)


def _single(setup, arch, steps=4, **hp):
    """The port's own single-device run (no process group)."""
    sys.path.insert(0, TESTS)
    try:
        from torch_dist_cases import FirstGrads
    finally:
        sys.path.remove(TESTS)
    tr = Trainer(_f32(get_smoke_config(arch)), TrainHParams(**{**HP, **hp}),
                 4, 32, device="cpu", ckpt_every=0,
                 params=torch.load(setup.params[arch], weights_only=True))
    with FirstGrads() as g:
        tr.run(steps, log_every=1)
    return {"loss": [r["loss"] for r in tr.log], "grads": g.grads,
            "aux": [r["aux"] for r in tr.log],
            "grad_norm": [r["grad_norm"] for r in tr.log]}


@pytest.fixture(scope="module")
def singles(setup):
    out = {name: _single(setup, arch, **hp) for name, (arch, hp)
           in PAIR.items()}
    out["qwen"] = _single(setup, QWEN)
    return out


def _check_run(run, ref, single, n_ref=3, grad_tol=1e-6):
    """Losses against the reference (1e-4); against the port's
    single-device run the losses and grad norms (1e-6 relative) and each
    leaf's first mean gradient (``grad_tol``, 1e-6, of the largest element
    of the whole gradient)."""
    _close(run["loss"][:n_ref], ref["loss"][:n_ref], 1e-4)
    n = len(run["loss"])
    _close(run["loss"], single["loss"][:n], 1e-6)
    _close(run["grad_norm"], single["grad_norm"][:n], 1e-6)
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    assert set(run["grads"]) == set(single["grads"])
    for name, g in run["grads"].items():
        err = float((g - single["grads"][name]).abs().max())
        assert err <= grad_tol * scale, (name, err, scale)


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_tp_geometry_equals_the_references(arch, tp):
    """``tp_geometry`` of the full and the smoke config against the
    reference's ``_tp_geometry`` under megatron on a (1, tp) mesh,
    including its None cases."""
    from repro.models import common as j_common
    from repro.models.transformer import _tp_geometry
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": tp})
    assert j_common.tp_mode() == "explicit"
    assert "model" not in j_common.batch_axes()
    for j_cfg, cfg in ((j_config(arch), get_config(arch)),
                       (j_smoke(arch), get_smoke_config(arch))):
        assert tp_geometry(cfg, tp) == _tp_geometry(j_cfg, mesh), arch


# ---------------------------------------------------------------- meshes


@pytest.mark.parametrize("mesh", ["12", "22", "14"])
def test_megatron_matches_the_reference_and_one_device(
        mesh, ranks2, ranks4, reference, singles):
    """qwen2.5-3b under megatron + ZeRO-1 at (1, 2) (kv heads split: 1 of
    2 a rank), (2, 2) and (1, 4) (each rank slices its kv head from the
    whole k / v): every rank's run against the reference's and the port's
    one device; each leaf held at its model shard."""
    ranks = ranks2 if mesh == "12" else ranks4
    key = {"12": "tp12", "22": "tp22", "14": "tp14"}[mesh]
    for out in ranks:
        run = out[key]["straight"] if mesh == "22" else out[key]
        _check_run(run, reference[f"qwen{mesh}"], singles["qwen"])
        tp = int(mesh[1])
        n = run["n"]
        assert n["decoder.attn.wq"] % tp == 0 and n["embed"] % tp == 0
        assert n["decoder.mlp.w_down"] % tp == 0


@pytest.mark.parametrize("name", sorted(PAIR))
def test_other_configs_at_one_by_two(name, ranks2, reference, singles):
    """At (1, 2): auto (no explicit block: every model-split leaf
    gathered), qwen3-8b (qk-norm: q_norm / k_norm by copy-to-model),
    dbrx-132b (TP attention and EP: 2 of 4 experts a rank, the router by
    copy-to-model), deepseek-v2-lite (MLA gathered, EP, the shared experts
    tensor-parallel; the aux loss within 1e-4 too), zamba2-1.2b (the
    shared block explicit, Mamba-2 gathered) and mamba2-1.3b (every leaf
    gathered).  The MoE models against the reference's one-device loss
    (its EP at (1, 2) is at fault: the test below), their aux losses
    within 1e-6 of the port's one device's."""
    for out in ranks2:
        if name in EP_FAULT:
            # Against the reference's one-device loss of the first batch;
            # the port's one device holds the MoE models' losses and
            # gradients to the reference's (tests/test_torch_train_moe.py).
            arch = PAIR[name][0]
            ref = {"loss": [reference["one_device_loss"][arch]]}
            _check_run(out[name], ref, singles[name], n_ref=1)
            _close(out[name]["aux"], singles[name]["aux"], 1e-6)
            assert out[name]["n"]["decoder.moe.w_gate"] == 2
        else:
            # zamba2's embedding gradient lands 1.09e-6 of the scale off
            # (every other leaf and model is inside 1e-6): the shared
            # block's two partial sums, carried back through the Mamba-2
            # layers into a gradient that sums every token's row.
            _check_run(out[name], reference[name], singles[name],
                       grad_tol=2e-6 if name == "zamba2" else 1e-6)
    assert ranks2[0][name]["loss"] == ranks2[1][name]["loss"]


def test_seamless_at_one_by_two(setup, ranks2, reference):
    """seamless-m4t (the encoder's and the decoder's self-attention and
    SwiGLU explicit, the cross-attention gathered) through
    ``make_train_step`` on batches with source frames: losses against the
    reference's, and against the port's one-device step within 1e-6 with
    the first mean gradient."""
    sys.path.insert(0, TESTS)
    try:
        import torch_dist_cases as cases
    finally:
        sys.path.remove(TESTS)
    one = cases.train_batches(_spec(setup, ENCDEC, (1, 1), steps=3))
    for out in ranks2:
        _check_run(out["seamless"], reference["seamless"], one)


def test_reference_blocks_give_its_one_device_gradients(reference):
    """The reference's Megatron attention and TP SwiGLU (shard_map with
    check_vma=False) at (1, 2) give each leaf's gradient within 1e-6 of its
    one-device gradient's scale on qwen3-8b (q_norm / k_norm replicated
    into the block); so the reference is an oracle for them."""
    errs = reference["leaf_grads"]["qwen3-8b"]
    bad = {n: e for n, e in errs.items() if e > 1e-6}
    assert not bad, bad


def test_reference_training_ep_takes_other_ranks_entries(reference,
                                                         ranks2):
    """A reference fault the port does not copy (ROADMAP Queue 3): the
    reference's training EP (``repro/models/moe.py:130-137``) shifts each
    entry's expert by the rank's first expert e0 and relies on
    out-of-bounds indices to drop the other ranks' entries, but an entry
    bound for an expert below e0 gets a negative index, which ``.at[]``
    wraps from the end: on rank 1 of (1, 2) the tokens of experts 0 and 1
    also run through experts 2 and 3 and are added into y.  Its dbrx and
    deepseek losses at (1, 2) then differ from its one-device losses, and
    its gradients by a large share of their scale, while the port's (1, 2)
    run drops them and keeps the one-device losses (within 1e-6 of the
    port's own one device: the test above)."""
    assert max(reference["leaf_grads"]["dbrx-132b"].values()) > 1e-2
    for name in EP_FAULT:
        one = reference["one_device_loss"][PAIR[name][0]]
        two = reference[name]["loss"][0]
        assert abs(two - one) > 1e-4 * abs(one), (name, one, two)
        for out in ranks2:
            assert out[name]["loss"][0] == pytest.approx(one, rel=1e-4)


# ---------------------------------------------------------------- int8


def test_grad_compress_at_two_by_two(ranks4, setup):
    """grad_compress at (2, 2): each model rank runs the int8 ring over its
    data group on its model shard's gradient.  The ring's result on every
    rank equals the ring rerun on the captured inputs (the port's ring, held
    to the reference's at 1e-6); the inputs' mean over the data ranks is
    the uncompressed (2, 2) run's first mean gradient (1e-6 of its
    scale); each error-feedback buffer is sized for the model shard; the
    losses within 1e-3 of the uncompressed run's (int8 rounding)."""
    runs = [out["compress22"] for out in ranks4]
    plain = ranks4[0]["plain22"]
    for run in runs:
        _close(run["loss"], plain["loss"], 1e-3)
    scale = max(float(g.abs().max()) for g in plain["grads"].values())
    for name in ("decoder.attn.wq", "decoder.ln1"):
        for m in range(2):          # model rank m: ranks m and 2 + m
            ins = [runs[d * 2 + m]["ring"][name] for d in range(2)]
            path = setup.dir / f"ring_{name}_{m}.npz"
            np.savez(path, x=np.stack([i["g"].numpy() for i in ins]),
                     g=np.stack([i["g"].numpy() for i in ins]),
                     e=np.stack([i["e"].numpy() for i in ins]))
            again = run_ranks("torch_dist_cases:ring", 2, args=[str(path)],
                              paths=[TESTS], timeout=TIMEOUT)
            for d in range(2):
                np.testing.assert_allclose(again[d]["mean"].numpy(),
                                           ins[d]["mean"].numpy(),
                                           rtol=1e-6, atol=1e-6)
            # The inputs are this model rank's shard of each data rank's
            # gradient: their mean is the uncompressed run's shard.
            mean = (ins[0]["g"] + ins[1]["g"]) / 2
            full = plain["grads"][name]
            if name == "decoder.attn.wq":   # [L, d, H, dh], H over model
                full = full.chunk(2, dim=2)[m]
            got = mean[:full.numel()].view(full.shape)
            assert float((got - full).abs().max()) <= 1e-6 * scale, name
            assert ins[0]["e"].numel() == gc.padded_size(full.numel(), 2)


# ---------------------------------------------------------------- counts


@pytest.mark.parametrize("remat,per_layer", [("save_collectives", 4),
                                             ("block", 6)])
def test_all_reduces_over_model_a_layer_and_step(remat, per_layer, ranks4):
    """At (2, 2), one step of the 2-layer qwen2.5-3b: 4 all-reduces over
    ``model`` a layer under "save_collectives" (2 reduces forward, 2
    copy-to-model backward; the recompute re-runs local math only), 6
    under "block", whose recompute reduces again, as the reference
    states; the gathered leaves' backward adds none."""
    L = get_smoke_config(QWEN).n_layers
    for out in ranks4:
        assert out[remat]["model_all_reduces"] == per_layer * L


# Runs with no checkpoint inside: name -> (mesh, arch, hp overrides).
SENT = {"block": ((2, 2), QWEN, {"remat": "block"}),
        "save_collectives": ((2, 2), QWEN, {"remat": "save_collectives"}),
        "plain22": ((2, 2), QWEN, {}),
        **{name: ((1, 2), arch, hp) for name, (arch, hp) in PAIR.items()}}


@pytest.mark.parametrize("name", sorted(SENT))
def test_dry_run_counts_the_bytes_a_training_step_sends(name, request):
    """``launch/dryrun.collective_bytes`` at the run's own cfg, batch (4 x
    32), mesh and hparams equals, by kind, the bytes each rank's
    collectives sent per step (``torch_dist_cases.Collectives`` over the
    run's steps); null for the families it does not count (zamba2,
    mamba2), whose runs still send."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh as TMesh
    shape, arch, hp = SENT[name]
    runs = request.getfixturevalue(f"ranks{int(np.prod(shape))}")
    want = dryrun.collective_bytes(
        _f32(get_smoke_config(arch)), ShapeConfig("train", 32, 4, "train"),
        TMesh(shape, ("data", "model")),
        {"kind": "train", "hp": TrainHParams(**{**HP, **hp})})
    for r, out in enumerate(runs):
        got = out[name]["sent"]
        if want is None:
            assert got["total"] > 0
            continue
        n = out[name]["step"] - out[name]["start"]
        assert set(got) <= set(want), (r, got)
        for kind, nbytes in want.items():
            assert got.get(kind, 0.0) / n == pytest.approx(
                nbytes, rel=1e-12), (r, kind, got, want)


# ---------------------------------------------------------------- ckpt


def test_resume_at_the_same_mesh_is_bitwise(ranks4):
    """(2, 2), resumed from the step-2 checkpoint: steps 3-4 end with the
    uninterrupted run's params and moments bit for bit, and its losses."""
    for out in ranks4:
        a, b = out["tp22"]["straight"], out["tp22"]["resumed"]
        assert b["start"] == 2 and a["step"] == b["step"] == 4
        assert b["loss"] == a["loss"][2:]
        for part in ("params", "mu", "nu"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (part, n)


@pytest.mark.parametrize("src,dst", [("14", "22"), ("12", "21"),
                                     ("14", "12")])
def test_restore_across_model_sizes_is_bitwise(src, dst, setup, ranks2,
                                               ranks4):
    """A checkpoint written at (1, 4) restored at (2, 2), one written at
    (1, 2) restored at (2, 1), and the (1, 4) one on the mesh that
    ``elastic_restart_plan`` gives 2 surviving ranks, (1, 2): every rank's
    state, gathered, equals the saved full arrays."""
    assert elastic_restart_plan(2, model_axis=4)[0] == (1, 2)
    step = 4
    d = setup.dir / f"tp{src}" / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    saved = {l["path"]: np.load(d / "arrays" / f"{l['idx']}.npy")
             for l in meta["leaves"]}
    key = {"22": "reshard14", "21": "reshard12", "12": "reshard14_elastic"}
    for out in (ranks4 if dst == "22" else ranks2):
        got = out[key[dst]]
        assert got["start"] == step and got["step"] == step
        for part, prefix in (("params", "params/"), ("mu", "opt/mu/"),
                             ("nu", "opt/nu/")):
            for n, t in got[part].items():
                np.testing.assert_array_equal(t.numpy(), saved[prefix + n])


def test_grad_compress_resume_restarts_error_feedback_in_both(
        ranks2, reference):
    """Shared behaviour, not a port fault: neither package checkpoints the
    error feedback, so a grad_compress run at D = 2 resumed from its step-2
    checkpoint restarts it at zero, and its next losses differ from the
    uninterrupted run's, in the port as in the reference."""
    ref = reference["compress_resume"]
    assert ref["start"] == 2 and ref["ef_max_at_resume"] == 0.0
    assert ref["ef_max_straight"] > 0
    assert ref["resumed"] != ref["straight"][2:]
    for out in ranks2:
        run = out["compress_resume"]
        assert run["ef_zero_at_resume"] is True
        assert run["resumed"]["start"] == 2
        assert run["resumed"]["loss"] != run["straight"]["loss"][2:]
        _close(run["straight"]["loss"][:3], ref["straight"][:3], 1e-3)


# ---------------------------------------------------------------- launcher


def test_mesh_of_a_model_axis_trains_under_megatron_by_default():
    """The default parallelism is megatron, and a (1, 2) mesh builds its
    step once a process group of its size exists (without one it raises:
    tests/test_torch_train_dist.py)."""
    assert TrainHParams().parallelism == "megatron"
    run = run_ranks("torch_dist_cases:suite", 2, args=[{
        "default": ("launcher", {"steps": 2})}], paths=[TESTS],
        timeout=TIMEOUT)
    for out in run:
        assert out["default"]["mesh"] == {"data": 1, "model": 2}
        assert out["default"]["parallelism"] == "megatron"
        assert np.isfinite(out["default"]["loss"]).all()
    assert run[0]["default"]["loss"] == run[1]["default"]["loss"]


# ---------------------------------------------------------------- chip


def test_chip_smoke_phase_9k_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 9k with the 'card' ranks on gloo CPU ranks."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.phase_train_tp("cpu") == {
        "flash_attention.train.tp": 0, "flash_attention_bwd.tp": 0}
