"""The port's cell specs and dry run against the reference's, on the CPU.

``launch/specs.py``'s ``serve_plan`` against the reference's for every
arch x shape x production mesh (with the pool and decode-state shapes it
sizes); ``build_cell``'s per-rank shapes against ``NamedSharding.
shard_shape`` of the reference's ``build_cell`` ``in_shardings``, which a
subprocess on 512 forced host devices builds through ``eval_shape`` only
(nothing compiled); the dry run over every cell with ``jax`` blocked.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from repro.configs import get_config as j_config
from repro.configs import list_archs
from repro.launch import specs as j_specs
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, TrainHParams
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import LM

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
try:
    from torch_reference_run import WAIT_SECONDS as TIMEOUT
finally:
    sys.path.remove(str(ROOT / "tests"))
# (arch, shape, multi_pod): the cells of tests/test_dryrun.py, the 2-D EP's
# decode of both MoE models, the long-context shape, and a multi-pod one.
CELLS = [("qwen2.5-3b", "train_4k", False), ("qwen2.5-3b", "decode_32k", False),
         ("deepseek-v2-lite-16b", "decode_32k", False),
         ("dbrx-132b", "decode_32k", False), ("qwen2.5-3b", "long_500k", False),
         ("qwen2.5-3b", "decode_32k", True)]

# The reference's build_cell on the production meshes (the first 256
# devices for one pod): every argument's global shape, dtype and
# NamedSharding.shard_shape by name; for a training cell also its params at
# its param_specs (the port keeps fp32 masters at the model shard).
_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.configs.base import TrainHParams
from repro.launch.sharding import param_specs
from repro.launch.specs import build_cell

cells = json.loads(sys.argv[1])
devs = np.array(jax.devices())
assert len(devs) == 512, len(devs)

def name_of(path):
    return ".".join(str(getattr(k, "key", getattr(k, "name",
                    getattr(k, "idx", k)))) for k in path)

PREFIX = {"train": ("params", "opt", "ef", "batch"),
          "prefill": ("params", "batch", "pools", "ctx", "last_pos"),
          "decode": ("params", "tokens", "pos", "pools", "ctx", "state")}
out = {}
for arch, shape, multi in cells:
    mesh = (Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model")) if multi
            else Mesh(devs[:256].reshape(16, 16), ("data", "model")))
    cell = build_cell(arch, shape, mesh,
                      TrainHParams(remat="block") if shape == "train_4k"
                      else None)
    rec = {}
    for pre, arg, sh in zip(PREFIX[cell["kind"]], cell["args"],
                            cell["in_shardings"]):
        if arg is None:
            continue
        leaves = jax.tree_util.tree_flatten_with_path(arg)[0]
        shards = jax.tree.leaves(sh)
        assert len(leaves) == len(shards), pre
        for (path, a), s in zip(leaves, shards):
            name = ".".join(x for x in (pre, name_of(path)) if x)
            if pre == "pools":
                name = "pools." + ("k", "v")[path[0].idx]
            rec[name] = [list(a.shape), str(a.dtype),
                         list(s.shard_shape(a.shape))]
    if cell["kind"] == "train":
        ps = param_specs(cell["args"][0], mesh)
        for (path, a), spec in zip(
                jax.tree_util.tree_flatten_with_path(cell["args"][0])[0],
                jax.tree.leaves(ps, is_leaf=lambda x: hasattr(x, "_partitions")
                                or type(x).__name__ == "PartitionSpec")):
            rec["model_shard." + name_of(path)] = list(
                NamedSharding(mesh, spec).shard_shape(a.shape))
    out[f"{arch}|{shape}|{multi}"] = rec
print(json.dumps(out))
"""


def _mesh(multi):
    return make_production_mesh(multi_pod=multi)


def _j_mesh(multi):
    return types.SimpleNamespace(
        axis_names=("pod", "data", "model") if multi else ("data", "model"),
        shape={"pod": 2, "data": 16, "model": 16} if multi
        else {"data": 16, "model": 16})


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(CELLS)], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_serve_plan_equals_the_references(arch, shape, multi):
    """``serve_plan`` (page shards, pages per shard, pool size, page and
    pool axes) equals the reference's on the production meshes, and the
    pools and decode state it sizes have the reference's shapes."""
    plan = specs.serve_plan(SHAPES[shape], _mesh(multi))
    j_plan = j_specs.serve_plan(j_specs.SHAPES[shape], _j_mesh(multi))
    assert vars(plan) == vars(j_plan)
    lm, jlm = LM(get_config(arch), device="meta"), JLM(j_config(arch))
    mine = lm.pool_shapes(plan.np_global, specs.GEO.page_tokens)
    theirs = jlm.pool_shapes(plan.np_global, j_specs.GEO.page_tokens)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert [tuple(s) for s, _ in mine] == [tuple(s.shape) for s in theirs]
    cfg = get_config(arch)
    src = cfg.encdec.source_len if cfg.encdec else 0
    B = SHAPES[shape].global_batch
    assert {k: tuple(s) for k, (s, _) in lm.init_state_shapes(
        B, src_len=src).items()} == {k: tuple(s.shape) for k, s in
                                     jlm.init_state_shapes(B, src).items()}


def _dtype(t):
    return str(t).replace("torch.", "")


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_build_cell_shards_equal_the_references(arch, shape, multi,
                                                reference):
    """Every input of the cell: its global shape, dtype and per-rank shape
    equal the reference's ``in_shardings``' ``shard_shape``.  A training
    cell's parameters are the one difference the port makes on purpose
    (ROADMAP 6c-iii): its ZeRO-1 keeps the fp32 masters whole over the
    data ranks, at the reference's ``param_specs`` shard, where the
    reference shards them like the moments."""
    mesh = _mesh(multi)
    hp = TrainHParams(remat="block") if shape == "train_4k" else None
    cell = specs.build_cell(arch, shape, mesh, hp)
    ref = reference[f"{arch}|{shape}|{multi}"]
    names = {n for n in ref if not n.startswith("model_shard.")}
    assert set(cell["inputs"]) == names
    for name in names:
        inp = cell["inputs"][name]
        gshape, dtype, rshape = ref[name]
        assert list(inp.shape) == gshape, name
        assert _dtype(inp.dtype) == dtype, name
        if cell["kind"] == "train" and name.startswith("params."):
            rshape = ref["model_shard." + name[len("params."):]]
        assert list(inp.shard_shape(mesh)) == rshape, (name, inp.spec)


def test_dry_run_covers_every_cell_without_jax():
    """``python -m repro_torch.launch.dryrun --all --mesh both`` with
    ``jax`` blocked: every one of the 80 cells prints its record (per-rank
    bytes whose sum is the parts', the card's capacity and its source, the
    three roofline terms at the H100 datasheet figures), and it exits 0
    with nothing of JAX or the reference loaded."""
    probe = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.launch import dryrun\n"
        "rc = dryrun.main(['--all', '--mesh', 'both'])\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.') or (m.startswith('jax') and "
        "sys.modules[m] is not None))\n"
        "print('BAD', bad)\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "BAD []" and "ALL CELLS PASSED" in lines
    recs = [json.loads(l) for l in lines if l.startswith("{")]
    assert len(recs) == 10 * 4 * 2
    for rec in recs:
        mem = rec["per_device_bytes"]
        assert mem["total"] == sum(mem["parts"].values()) > 0
        assert rec["capacity_source"].startswith("NVIDIA H100 SXM5")
        assert rec["fits"] == (mem["total"] <= rec["capacity_bytes"])
        assert rec["compute_s"] > 0 and rec["memory_s"] > 0
        # Serving is counted for every family; training for dense and moe
        # without grad_compress (ROADMAP Queue 1).
        counted = rec["collective_bytes_per_chip"] is not None
        assert counted == (not rec["shape"].startswith("train") or (
            get_config(rec["arch"]).family in ("dense", "moe")
            and not rec["grad_compress"]))
        assert (rec["collective_s"] is None) == (not counted)
    qwen = {(r["shape"], r["mesh"]): r for r in recs
            if r["arch"] == "qwen2.5-3b"}
    # Serving decode over a 16-way page stripe combines partials; training
    # under megatron all-reduces over model and reduce-scatters over data.
    assert qwen[("decode_32k", "16x16")]["plan"]["S"] == 16
    train = qwen[("train_4k", "16x16")]["collective_bytes_per_chip"]
    assert train["all_reduce"] > 0 and train["reduce_scatter"] > 0


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", "decode_32k"),
                                        ("zamba2-1.2b", "prefill_32k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_build_cell_cuts_mamba_leaves_and_state_by_heads(arch, shape):
    """A serving cell's Mamba-2 leaves hold the rank's heads
    (``sharding.head_cut``, which no spec says): every leaf's per-rank
    shape is what ``serving_placements`` cuts, ``w_in`` with the rank's
    z, x and dt columns and B, C whole; the decode state's ``ssm`` splits
    its heads over ``model`` and ``conv`` holds the rank's channels."""
    from repro_torch.launch.sharding import serving_placements
    from repro_torch.models.mamba2 import dims
    mesh = _mesh(False)
    tp = mesh.shape["model"]
    cfg = get_config(arch)
    cell = specs.build_cell(arch, shape, mesh)
    params = dict(LM(cfg, device="meta").named_parameters())
    places = serving_placements(cfg, params, mesh, 0)
    d_in, nh, cd = dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    for name, p in params.items():
        got = cell["inputs"][f"params.{name}"].shard_shape(mesh)
        assert got == tuple(places[name].take(p).shape), name
        if name.endswith(".w_in"):
            assert got[-1] == 2 * d_in // tp + 2 * gn + nh // tp
    if SHAPES[shape].kind == "decode":
        B = SHAPES[shape].global_batch // (
            mesh.shape["data"] if cell["plan"].batch_sharded else 1)
        ssm = cell["inputs"]["state.ssm"].shard_shape(mesh)
        conv = cell["inputs"]["state.conv"].shard_shape(mesh)
        assert ssm == (cfg.n_layers, B, nh // tp, cfg.ssm.head_dim,
                       cfg.ssm.d_state)
        assert conv == (cfg.n_layers, B, cfg.ssm.d_conv - 1,
                        d_in // tp + 2 * gn)


def test_chip_smoke_phase_10_rehearsed_on_the_cpu():
    """chip_smoke.py's phase 10 with the card's ranks on gloo CPU ranks
    and the smoke configs in (a), (b), (e) and (f): the mesh's logits
    within their limits of one rank's ((e) in f32 and, as a sanity check,
    bf16) and the negative controls beyond them, the narrow f32 models'
    ranks of (c) and (g) against CPU ranks, the dry-run lines; every
    kernels-line entry of the phase, with no launch on the CPU."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.phase_serve_mesh("cpu") == {
        "flash_attention.mesh": 0, "paged_attention.mesh": 0,
        "flash_attention.mla.mesh": 0, "paged_attention.mla.mesh": 0,
        "ssd_scan.mesh": 0, "flash_attention.hybrid.mesh": 0,
        "paged_attention.hybrid.mesh": 0,
        "flash_attention.encoder.mesh": 0,
        "flash_attention.decoder.mesh": 0,
        "flash_attention.cross_prefill.mesh": 0,
        "flash_attention.cross_decode.mesh": 0,
        "paged_attention.encdec.mesh": 0}
