"""The port's data-parallel training over gloo ranks against the reference
on forced host devices, on the CPU.

The port runs on D ∈ {1, 2, 4} ranks, each its own process
(``repro_torch.launch.spawn.run_ranks``: a ``FileStore`` rendezvous in a
temporary directory, a hard timeout that fails the test); the rank
functions are in ``tests/torch_dist_cases.py``.  The reference runs once,
in its own process with ``XLA_FLAGS`` forcing 4 host devices (set before
jax is imported), on the same mesh shapes (the first D devices).  Both
start from the same weights: the reference's ``LM.init`` at seed 0, which
its Trainer draws itself and the port loads through the bridge.

Tolerances, stated per test: the int8 ring at the reference's 1e-6 (XLA
fuses some of its f32 operations, see the ring's test); losses 1e-4
relative of the reference's (the standing training gate); the port's
D-rank run within
1e-6 of its own single-device run (losses relative, params of each leaf's
scale: the reductions sum the same f32 terms in another order);
compressed against uncompressed losses 1e-3 relative (int8 rounding of the
gradients); resumes bitwise.
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
from repro.launch import sharding as j_sharding
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainHParams
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.lm import LM
from repro_torch.train import grad_compress as gc
from repro_torch.train.trainer import Trainer, make_train_step

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
QWEN, DEEPSEEK = "qwen2.5-3b", "deepseek-v2-lite-16b"
HP = dict(lr=1e-3, warmup_steps=2, total_steps=50, microbatch=0,
          remat="none", grad_compress=False)
RING_N = 3 * 4 * gc.BLOCK           # three blocks per chunk on 4 ranks
sys.path.insert(0, TESTS)
try:
    from torch_reference_run import WAIT_SECONDS as TIMEOUT
    from torch_reference_run import ReferenceRun
finally:
    sys.path.remove(TESTS)

# The reference on 4 forced host devices: the ring with each device's own
# input (in_specs=P("data")), the Trainer on the port's mesh shapes, and
# the compiled step's all-reduces with and without grad_compress.
_REFERENCE = r"""
import dataclasses, json, re, sys
import numpy as np
import jax
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro import compat
from repro.compat import shard_map
from repro.configs import get_smoke_config
from repro.configs.base import TrainHParams
from repro.train import grad_compress as gc
from repro.train.trainer import Trainer

inputs, out_dir, hp = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
devs = np.array(jax.devices())
assert len(devs) == 4, devs

def mesh_of(shape, axes=("data", "model")):
    n = int(np.prod(shape))
    return Mesh(devs[:n].reshape(shape), axes,
                axis_types=(AxisType.Auto,) * len(axes))

arrays, out = {}, {}
data = np.load(inputs)
for D in (2, 4):
    mesh = mesh_of((D,), ("data",))
    x, g, e = (data[f"{k}{D}"].reshape(-1) for k in ("x", "g", "e"))
    ring = shard_map(lambda v: gc._ring_allreduce_q(v, "data"), mesh=mesh,
                     in_specs=P("data"), out_specs=P("data"),
                     check_vma=False)(x)
    mean, err = shard_map(
        lambda a, b: gc.compressed_allreduce_flat(a, b, "data"), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
        check_vma=False)(g, e)
    for k, v in (("ring", ring), ("mean", mean), ("err", err)):
        arrays[f"{k}{D}"] = np.asarray(v).reshape(D, -1)

def trainer(arch, shape, **kw):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return Trainer(cfg, TrainHParams(**hp, **kw), mesh_of(shape),
                   batch_per_step=4, seq_len=32, ckpt_every=0)

def first_batch(tr):
    return {k: jax.device_put(v, tr._bs)
            for k, v in tr.data.batch_at(0).items()}

def run(name, arch, shape, **kw):
    tr = trainer(arch, shape, **kw)
    rec = out[name] = {"loss": [], "aux": []}
    with compat.set_mesh(tr.mesh):
        for i in range(3):
            batch = {k: jax.device_put(v, tr._bs)
                     for k, v in tr.data.batch_at(i).items()}
            tr.params, tr.opt, tr.ef, m = tr.step_fn(tr.params, tr.opt,
                                                     tr.ef, batch)
            rec["loss"].append(float(m["loss"]))
            rec["aux"].append(float(m["aux"]))
    return tr

def all_reduces(tr):
    with compat.set_mesh(tr.mesh):
        text = tr.step_fn.lower(tr.params, tr.opt, tr.ef,
                                first_batch(tr)).compile().as_text()
    lines = text.splitlines()
    ar = sorted(re.search(r"= (\(.*?\)|\S+) all-reduce", l).group(1)
                for l in lines if re.search(r"\ball-reduce(-start)?\(", l))
    s8 = sum("collective-permute" in l and "s8[" in l for l in lines)
    return {"all_reduce": [a for a in ar if "f32" in a], "s8_permutes": s8}

run("megatron2", "qwen2.5-3b", (2, 1))
tr = run("megatron4", "qwen2.5-3b", (4, 1))
out["hlo"] = all_reduces(tr)
out["hlo_compress"] = all_reduces(trainer("qwen2.5-3b", (4, 1),
                                          grad_compress=True))
run("fsdp22", "qwen2.5-3b", (2, 2), parallelism="fsdp")
run("deepseek2", "deepseek-v2-lite-16b", (2, 1))
np.savez(f"{out_dir}/ref_arrays.npz", **arrays)
with open(f"{out_dir}/ref.json", "w") as f:
    json.dump(out, f)
"""


def _f32(arch):
    return dataclasses.replace(j_smoke(arch), dtype="float32")


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
    """Weights, ring inputs, and the reference's process, started here so
    that it runs while the port's ranks do."""
    d = tmp_path_factory.mktemp("dist")
    paths = {}
    for arch in (QWEN, DEEPSEEK):
        jp = jax.tree.map(np.asarray, JLM(_f32(arch)).init(
            jax.random.PRNGKey(0)))
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(params_from_jax(jp), paths[arch])
    rng = np.random.default_rng(7)
    rings = {}
    for D in (1, 2, 4):
        for k, scale in (("x", 3.0), ("g", 1.0), ("e", 1e-2)):
            rings[f"{k}{D}"] = (rng.normal(size=(D, RING_N)) * scale
                                ).astype(np.float32)
        np.savez(d / f"ring{D}.npz",
                 **{k: rings[f"{k}{D}"] for k in ("x", "g", "e")})
    np.savez(d / "rings.npz", **rings)
    ref = ReferenceRun(_REFERENCE, [
        d / "rings.npz", d,
        json.dumps({k: v for k, v in HP.items() if k != "grad_compress"})],
        d, fast=False)
    yield types.SimpleNamespace(dir=d, params=paths, rings=rings, ref=ref)
    ref.close()


@pytest.fixture(scope="module")
def reference(setup):
    setup.ref.wait()
    with open(setup.dir / "ref.json") as f:
        out = json.load(f)
    out["arrays"] = dict(np.load(setup.dir / "ref_arrays.npz"))
    return out


def _spec(setup, arch, mesh, **kw):
    return dict(arch=arch, mesh=list(mesh), params=setup.params[arch], **kw)


def _ranks(world, cases):
    return run_ranks("torch_dist_cases:suite", world, args=[cases],
                     paths=[TESTS], timeout=TIMEOUT)


@pytest.fixture(scope="module")
def ranks4(setup):
    d = setup.dir
    return _ranks(4, {
        "ring": ("ring", str(d / "ring4.npz")),
        "megatron": ("train", _spec(setup, QWEN, (4, 1), steps=4,
                                    count=True)),
        "compress": ("train", _spec(setup, QWEN, (4, 1), steps=3,
                                    count=True,
                                    hp=dict(grad_compress=True))),
        "fsdp": ("train_and_resume", _spec(
            setup, QWEN, (2, 2), hp=dict(parallelism="fsdp"),
            ckpt_dir=str(d / "fsdp4"))),
        "fsdp_step": ("train", _spec(setup, QWEN, (2, 2), steps=1,
                                     hp=dict(parallelism="fsdp"))),
    })


@pytest.fixture(scope="module")
def ranks2(setup, ranks4):
    d = setup.dir
    return _ranks(2, {
        "ring": ("ring", str(d / "ring2.npz")),
        "megatron": ("train_and_resume", _spec(setup, QWEN, (2, 1),
                                               ckpt_dir=str(d / "zero2"))),
        "deepseek": ("train", _spec(setup, DEEPSEEK, (2, 1), steps=3)),
        # The D = 4 fsdp run's step-4 checkpoint onto 2 ranks.
        "reshard": ("restored", _spec(setup, QWEN, (2, 1),
                                      hp=dict(parallelism="fsdp"),
                                      ckpt_dir=str(d / "fsdp4"))),
        "preempt": ("preempt", _spec(setup, QWEN, (2, 1),
                                     ckpt_dir=str(d / "preempt"))),
    })


@pytest.fixture(scope="module")
def ranks1(setup):
    return _ranks(1, {
        "ring": ("ring", str(setup.dir / "ring1.npz")),
        "megatron": ("train", _spec(setup, QWEN, (1, 1), steps=4)),
    })


@pytest.fixture(scope="module")
def single(setup):
    """The port's own single-device run (no process group), 4 steps."""
    cfg = dataclasses.replace(get_smoke_config(QWEN), dtype="float32")
    sys.path.insert(0, TESTS)
    try:
        from torch_dist_cases import FirstGrads
    finally:
        sys.path.remove(TESTS)
    tr = Trainer(cfg, TrainHParams(**HP), 4, 32, device="cpu", ckpt_every=0,
                 params=torch.load(setup.params[QWEN], weights_only=True))
    with FirstGrads() as g:
        tr.run(4, log_every=1)
    return {"loss": [r["loss"] for r in tr.log], "grads": g.grads,
            "grad_norm": [r["grad_norm"] for r in tr.log],
            "params": {n: p.detach().clone() for n, p in tr.params.items()}}


# ---------------------------------------------------------------- (1) ring


@pytest.mark.parametrize("D", [2, 4])
def test_ring_and_compressed_allreduce_match_the_reference(
        D, request, reference):
    """Each rank feeds its own vector: the ring's, the mean's and the error
    feedback's values on every rank against the reference's under
    ``shard_map(in_specs=P("data"))``, at the reference's own 1e-6
    (``tests/test_train.py``), not bitwise: compiled, XLA computes the
    scale's ``max / 127`` as ``max * (1 / 127)`` and contracts the
    dequantize-and-accumulate ``acc + q * s`` into one fused multiply-add,
    while the port rounds each operation as the reference's eager ops do
    (``tests/test_torch_train.py`` holds those bitwise); the two differ
    in the last bit of some elements."""
    ranks = request.getfixturevalue(f"ranks{D}")
    ref = reference["arrays"]
    for r, out in enumerate(ranks):
        for k in ("ring", "mean", "err"):
            np.testing.assert_allclose(out["ring"][k].numpy(),
                                       ref[f"{k}{D}"][r], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    # Rank r holds chunk (r + 1) % D as its own f32 sum, the others as
    # their holders' int8 rounding of theirs: the ranks' results differ.
    assert not np.array_equal(ranks[0]["ring"]["ring"].numpy(),
                              ranks[1]["ring"]["ring"].numpy())


def test_compressed_allreduce_on_one_rank_is_the_exact_path(setup, ranks1):
    """A world of one rank: no wire; the ring returns its input and the
    mean is dequant(quant(g + e)), bitwise the group-less call's."""
    out = ranks1[0]["ring"]
    x, g, e = (torch.tensor(setup.rings[f"{k}1"][0])
               for k in ("x", "g", "e"))
    np.testing.assert_array_equal(out["ring"].numpy(), x.numpy())
    x_ = (g + e).numpy()
    mean, err = gc.compressed_allreduce_flat(g, e, None)
    np.testing.assert_array_equal(out["mean"].numpy(), mean.numpy())
    np.testing.assert_array_equal(out["err"].numpy(), err.numpy())
    np.testing.assert_allclose((mean + err).numpy(), x_, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------- (2) specs


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")), ((2, 2), ("data", "model"))]


def _flat_specs(tree):
    P = jax.sharding.PartitionSpec
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_sharding_specs_equal_the_references(arch):
    """param_specs, zero1_specs, fsdp_specs and serving_param_specs (with
    and without 2D EP) of the full config on four meshes, from abstract
    params on both sides (``jax.eval_shape``; the port's meta device)."""
    abstract = jax.eval_shape(JLM(j_config(arch)).init, jax.random.PRNGKey(0))
    named = dict(LM(get_config(arch), device="meta",
                    master=True).named_parameters())
    assert set(named) == {
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    for shape, axes in MESHES:
        jmesh = types.SimpleNamespace(axis_names=axes,
                                      shape=dict(zip(axes, shape)))
        mesh = Mesh(shape, axes)
        pairs = [(j_sharding.param_specs(abstract, jmesh),
                  sharding.param_specs(named, mesh)),
                 (j_sharding.zero1_specs(abstract, jmesh),
                  sharding.zero1_specs(named, mesh)),
                 (j_sharding.fsdp_specs(abstract, jmesh),
                  sharding.fsdp_specs(named, mesh))]
        pairs += [(j_sharding.serving_param_specs(abstract, jmesh, ep),
                   sharding.serving_param_specs(named, mesh, ep))
                  for ep in (False, True)]
        for want, got in pairs:
            assert got == _flat_specs(want), (arch, shape)


# ---------------------------------------------------------------- (3) DP


def _check_run(run, ref, single, D, sharded_over):
    """Losses against the reference (1e-4); against the port's
    single-device run, the 4 steps' losses and grad norms (1e-6 relative)
    and the first update's mean gradient (1e-6 of the largest element of
    the whole gradient).  Not the params after AdamW steps: where a
    gradient is zero in exact arithmetic (the key bias's: softmax ignores a
    shift of every score), the computed one is rounding noise, which
    AdamW's m / sqrt(v) turns into steps of up to the learning rate, and
    the two reductions' noise differs.  Each moment shard is 1 / n of its
    leaf, n = D for every leaf sharded over all ``sharded_over`` ranks."""
    _close(run["loss"][:3], ref["loss"], 1e-4)
    _close(run["loss"], single["loss"], 1e-6)
    _close(run["grad_norm"], single["grad_norm"], 1e-6)
    scale = max(float(g.abs().max()) for g in single["grads"].values())
    for n, g in run["grads"].items():
        err = float((g - single["grads"][n]).abs().max())
        assert err <= 1e-6 * scale, (n, err, scale)
    full = {n: p.numel() for n, p in run["params"].items()}
    assert all(run["shard"][n] * run["n"][n] == full[n] for n in full)
    assert sum(run["n"][n] == sharded_over for n in full) >= len(full) // 2
    assert all(run["n"][n] in (1, 2, sharded_over) for n in full)


@pytest.mark.parametrize("D", [2, 4])
def test_megatron_zero1_matches_the_reference_and_one_device(
        D, request, reference, single):
    ranks = request.getfixturevalue(f"ranks{D}")
    for r, out in enumerate(ranks):
        run = out["megatron"]["straight"] if D == 2 else out["megatron"]
        _check_run(run, reference[f"megatron{D}"], single, D, D)
        assert all(n in (1, D) for n in run["n"].values())


def test_fsdp_on_two_by_two_matches_the_reference_and_one_device(
        ranks4, reference, single):
    for out in ranks4:
        _check_run(out["fsdp"]["straight"], reference["fsdp22"], single, 4,
                   4)


def test_world_of_one_rank_is_bitwise_the_groupless_run(ranks1, single):
    """A (1, 1) mesh over a one-rank gloo group trains exactly as the
    Trainer without a mesh."""
    run = ranks1[0]["megatron"]
    assert run["loss"] == single["loss"]
    for n, p in run["params"].items():
        assert torch.equal(p, single["params"][n]), n


# ---------------------------------------------------------------- (4) MoE


def test_deepseek_loss_and_aux_over_two_ranks_match_the_reference(
        ranks2, reference):
    """MLA + MoE at (2, 1): the load-balance aux over both ranks' rows
    (E · Σ mean(me) · mean(fe)), the loss and aux within 1e-4."""
    ref = reference["deepseek2"]
    for out in ranks2:
        _close(out["deepseek"]["loss"], ref["loss"], 1e-4)
        _close(out["deepseek"]["aux"], ref["aux"], 1e-4)
    assert ranks2[0]["deepseek"]["aux"] == ranks2[1]["deepseek"]["aux"]


# ---------------------------------------------------------------- (5) int8


def test_grad_compress_over_four_ranks(ranks4):
    """Losses within 1e-3 of uncompressed DP; each rank's error feedback
    is nonzero and its own."""
    for out in ranks4:
        _close(out["compress"]["loss"], out["megatron"]["loss"][:3], 1e-3)
    efs = [out["compress"]["ef"] for out in ranks4]
    for n in efs[0]:
        assert all(float(e[n].abs().max()) > 0 for e in efs), n
        assert not torch.equal(efs[0][n], efs[1][n]), n
    assert efs[0]["embed"].numel() == gc.padded_size(512 * 64, 4)


def test_reference_compression_keeps_the_f32_reduction_and_the_port_not(
        reference, ranks4):
    """The reference's compressed step (4, 1) compiles to the same f32
    all-reduces as its uncompressed step, the gradient-shaped operands
    included: its ring (the s8
    collective-permutes) runs on top of the f32 reduction.  The port's
    compressed step issues no f32 reduction of a gradient: the ring's
    int8 payloads and f32 scales carry it, and only the loss metrics (3
    values) and the grad norm (1) are all-reduced in f32; the uncompressed
    step reduce-scatters every gradient leaf."""
    plain, comp = reference["hlo"], reference["hlo_compress"]
    assert comp["all_reduce"] == plain["all_reduce"]
    # A layer's weight gradients (wq [64, 4, 16] ... w_down [128, 64]) in
    # one tuple, and the embedding's [512, 64].
    layer = [a for a in plain["all_reduce"] if "f32[64,4,16]" in a
             and "f32[128,64]" in a]
    assert layer and any("f32[512,64]" in a for a in plain["all_reduce"])
    assert plain["s8_permutes"] == 0 < comp["s8_permutes"]
    n_leaves = len(ranks4[0]["megatron"]["params"])
    for out in ranks4:
        calls = out["compress"]["calls"]
        big_f32 = [c for c in calls if c[0] in ("all_reduce",
                                                "reduce_scatter_tensor",
                                                "broadcast")
                   and c[1] == "torch.float32" and c[2] > 3]
        assert big_f32 == [], big_f32
        p2p = {c[1] for c in calls if c[0] in ("isend", "irecv")}
        assert p2p == {"torch.int8", "torch.float32"}
        plain_calls = out["megatron"]["calls"]
        assert sum(c[0] == "reduce_scatter_tensor"
                   for c in plain_calls) == 4 * n_leaves
        assert not any(c[0] in ("isend", "irecv") for c in plain_calls)


# ---------------------------------------------------------------- (6) ckpt


@pytest.mark.parametrize("D", [2, 4])
def test_resume_at_the_same_world_size_is_bitwise(D, request):
    """ZeRO-1 at D = 2, fsdp at D = 4: resumed from the step-2 checkpoint,
    steps 3-4 end with the uninterrupted run's params and moments, bit for
    bit, and with its losses."""
    key = "megatron" if D == 2 else "fsdp"
    for out in request.getfixturevalue(f"ranks{D}"):
        a, b = out[key]["straight"], out[key]["resumed"]
        assert b["start"] == 2 and a["step"] == b["step"] == 4
        assert b["loss"] == a["loss"][2:]
        for part in ("params", "mu", "nu"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (part, n)


def test_resume_across_world_sizes_restores_bitwise(setup, ranks2):
    """The fsdp run's step-4 checkpoint written by 4 ranks, restored on 2:
    every rank's state, gathered, equals the saved full arrays."""
    d = setup.dir / "fsdp4" / "step_00000004"
    meta = json.loads((d / "meta.json").read_text())
    saved = {l["path"]: np.load(d / "arrays" / f"{l['idx']}.npy")
             for l in meta["leaves"]}
    for out in ranks2:
        got = out["reshard"]
        assert got["start"] == 4 and got["step"] == 4
        for part, prefix in (("params", "params/"), ("mu", "opt/mu/"),
                             ("nu", "opt/nu/")):
            for n, t in got[part].items():
                np.testing.assert_array_equal(t.numpy(), saved[prefix + n])
        assert any(v == 2 for v in got["n"].values())


# ---------------------------------------------------------------- (7) SIGTERM


def test_sigterm_to_one_rank_stops_both_at_the_same_step(setup, ranks2):
    """Rank 1 of 2 gets SIGTERM: both ranks finish the same step, write its
    checkpoint and exit 0 (the spawn fails otherwise)."""
    stopped = [out["preempt"]["stopped"] for out in ranks2]
    assert stopped[0] == stopped[1] >= 2
    assert all(out["preempt"]["latest"] == stopped[0] for out in ranks2)
    assert (setup.dir / "preempt" / f"step_{stopped[0]:08d}"
            / "_COMPLETE").exists()


# ---------------------------------------------------------------- (8) TP


@pytest.mark.parametrize("parallelism", ["megatron", "auto"])
def test_model_axis_over_one_raises_under_megatron(parallelism):
    """A mesh of several ranks without a process group of its size raises,
    with a ``model`` axis > 1 (tensor / expert parallelism, which trains
    since it was ported: tests/test_torch_train_tp.py) as without one."""
    cfg = dataclasses.replace(get_smoke_config(QWEN), dtype="float32")
    hp = TrainHParams(**{**HP, "parallelism": parallelism})
    for shape in ((2, 2), (2, 1)):
        with pytest.raises(RuntimeError, match="process group"):
            make_train_step(LM(cfg, master=True), hp,
                            Mesh(shape, ("data", "model")))


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_moment_specs_equal_the_references(arch):
    """``batch_spec`` and both parts of ``state_specs`` (the f32 masters'
    specs and the optimizer moments') under megatron, auto and fsdp equal
    the reference's, on every architecture: ZeRO-1 keeps the masters at
    the moments' layout, as the reference does."""
    from repro.configs.base import TrainHParams as JHP
    from repro.train import trainer as j_trainer
    from repro_torch.train.trainer import batch_spec, state_specs
    abstract = jax.eval_shape(JLM(_f32(arch)).init, jax.random.PRNGKey(0))
    named = dict(LM(dataclasses.replace(get_smoke_config(arch),
                                        dtype="float32"), device="meta",
                    master=True).named_parameters())
    try:
        for par, shape in (("megatron", (2, 1)), ("fsdp", (2, 2)),
                           ("megatron", (16, 16)), ("auto", (2, 2))):
            axes = ("data", "model")
            jmesh = types.SimpleNamespace(axis_names=axes,
                                          shape=dict(zip(axes, shape)))
            mesh = Mesh(shape, axes)
            jhp = JHP(parallelism=par)
            j_trainer.configure_parallelism(jhp)
            hp = TrainHParams(parallelism=par)
            assert batch_spec(mesh, hp) == tuple(j_trainer.batch_spec(jmesh))
            j_params, j_moments = j_trainer.state_specs(abstract, jhp, jmesh)
            params, moments = state_specs(named, hp, mesh)
            assert moments == _flat_specs(j_moments), (par, shape)
            assert params == _flat_specs(j_params), (par, shape)
    finally:
        j_trainer.configure_parallelism(JHP())


# Runs with no checkpoint inside: name -> (world, its case there, mesh,
# arch, hp overrides).
SENT = {"megatron1": (1, "megatron", (1, 1), QWEN, {}),
        "megatron4": (4, "megatron", (4, 1), QWEN, {}),
        "fsdp": (4, "fsdp_step", (2, 2), QWEN, {"parallelism": "fsdp"}),
        "deepseek": (2, "deepseek", (2, 1), DEEPSEEK, {}),
        "compress": (4, "compress", (4, 1), QWEN, {"grad_compress": True})}


@pytest.mark.parametrize("name", sorted(SENT))
def test_dry_run_counts_the_bytes_a_data_parallel_step_sends(name, request):
    """``launch/dryrun.collective_bytes`` at the run's own cfg, batch (4 x
    32), mesh and hparams equals, by kind, the bytes each rank's
    collectives sent per step (``torch_dist_cases.Collectives``): ZeRO-1's
    reduce-scatters and its gathers of the cast copies, FSDP's gathers and
    reduce-scatters, the MoE loads' all-reduce, ``grad_compress``'s int8
    ring hops (``p2p``) in place of the f32 reduction; nothing on one
    rank."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    world, key, shape, arch, hp = SENT[name]
    want = dryrun.collective_bytes(
        dataclasses.replace(get_smoke_config(arch), dtype="float32"),
        ShapeConfig("train", 32, 4, "train"),
        Mesh(shape, ("data", "model")),
        {"kind": "train", "hp": TrainHParams(**{**HP, **hp})})
    for r, out in enumerate(request.getfixturevalue(f"ranks{world}")):
        got = out[key]["sent"]
        n = out[key]["step"] - out[key]["start"]
        assert set(got) <= set(want), (r, got)
        for kind, nbytes in want.items():
            assert got.get(kind, 0.0) / n == pytest.approx(
                nbytes, rel=1e-12), (r, kind, got, want)
    if world == 1:
        assert want["total"] == 0


# ---------------------------------------------------------------- chip


def test_chip_smoke_phase_9j_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 9j with the 'card' runs on gloo CPU ranks."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    chip_smoke.phase_train_dist("cpu")
