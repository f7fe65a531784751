"""The port's serving over a mesh of gloo ranks for the hybrid, ssm, encdec
and vlm families against the reference's mesh runs on forced host
devices, on the CPU.

zamba2 (hybrid), mamba2 (ssm), seamless (encdec) and llava (vlm), their
smoke configs in f32, serve four prompts (a prefill, then two decode
steps) on 2 ranks at (1, 2), on 4 at (2, 2) with the batch split over
``data``, and on 4 at (2, 2) unsplit, the pages striped over every rank.
The Mamba-2 layers run on each rank's heads (the SSD scan at nh / tp
heads, the gated norm's sum of squares summed over ``model``, ``w_out``
row-parallel); zamba2's shared block and the decoders' self-attention run
the dense mesh path over the rank's stripe of the pools; seamless's
encoder and cross-attention run at the rank's heads; llava's patch
embeddings take the rank's rows.  The port's ranks are processes of
``repro_torch.launch.spawn.run_ranks`` (rank functions in
``tests/torch_serve_cases.py``); the reference runs once, in its own
process on 4 forced host devices at XLA's optimisation level 0.  Weights
come from the reference's ``LM.init`` at seed 0 (the port's through the
bridge).

Tolerances: the logits within 1e-5 of their scale of the reference's mesh
run (two packages' f32 products), and within 1e-6 of the port's one-rank
run (the ranks' partial products summed in another order; zamba2 2e-6,
see ``ONE_RANK_TOL``); the decode state gathered over the ranks within
the same of the port's one rank and 1e-5 of the reference's.
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

from repro.configs import get_smoke_config as j_smoke
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_jax, serving_shard_from_jax
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import serving_placements, spec_for
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.specs import serve_plan
from repro_torch.models.common import ParallelCtx
from repro_torch.models.lm import LM as TLM
from repro_torch.models.mamba2 import dims

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
sys.path.insert(0, TESTS)
try:
    import torch_serve_cases as cases
    from torch_reference_run import WAIT_SECONDS, ReferenceRun
finally:
    sys.path.remove(TESTS)

SSM, HYBRID = "mamba2-1.3b", "zamba2-1.2b"
ENCDEC = "seamless-m4t-large-v2"
# The mesh's logits and decode state against the port's one rank, of
# their scale.  zamba2's read up to 1.40e-6 (logits) and 1.33e-6 (the ssm
# state after the last step): its shared block's partial products and the
# Mamba-2 gated norm's partial sums of squares (two or four where one rank
# takes one mean, and it divides every channel of the block) are summed
# in another order, and each shared-block invocation carries that into
# the next six Mamba-2 layers.  The reference itself is 1.18e-6 off its
# own one device there.  Every other family and state reads under 9e-7.
ONE_RANK_TOL = {HYBRID: 2e-6}

# The reference on 4 forced host devices: each family's prefill and decode
# steps on one device and under each mesh, with the decode state after
# the prefill and after the last step.
_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs import get_smoke_config
from repro.models import common
from repro.models.lm import LM
from repro.models.transformer import PageCtx

inp, out_path, archs = sys.argv[1:4]
data = dict(np.load(inp))
meta = json.load(open(inp + ".json"))
ptok, fp = meta["geo"]
npr, lengths = meta["pages_per_rank"], meta["lengths"]
devs = np.array(jax.devices())
assert len(devs) == 4, devs
common.set_batch_axes(("pod", "data"))
common.set_serving_mode(True)
out = {}

def mesh_of(shape):
    return Mesh(devs[:int(np.prod(shape))].reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)

def ctx(key, split):
    return PageCtx(**{k: jnp.asarray(data[f"{key}.{k}"])
                      for k in ("tables", "ntok", "wpage", "wslot")},
                   batch_sharded=split, frame_pages=fp)

def under(name, fn, *args):
    if name == "one":
        return jax.jit(fn)(*args)
    with compat.set_mesh(mesh_of(meta["meshes"][name][0])):
        return jax.jit(fn)(*args)

for arch in json.loads(archs):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = LM(cfg)
    params = lm.init(jax.random.PRNGKey(0))
    vlm = cfg.family == "vlm"
    n_pre = cfg.frontend_tokens if vlm else 0
    batch = {"tokens": jnp.asarray(data["lm.tokens0"])}
    if vlm:
        batch["patch_embeds"] = jnp.asarray(data["fam.patch_embeds"])
    if cfg.family == "encdec":
        batch["src_embeds"] = jnp.asarray(data["fam.src_embeds"])
    for name in ("one", "12", "22", "22u"):
        key = ("vlm." if vlm else "") + name
        pages = npr * (4 if name == "one"
                       else int(np.prod(meta["meshes"][name][0])))
        shapes = lm.pool_shapes(pages, ptok)
        pools = None if shapes is None else tuple(
            jnp.zeros(s.shape, jnp.float32) for s in shapes)
        split = name == "one" or meta["meshes"][name][1]
        def prefill(p, b, pools, c, last):
            return lm.prefill(p, b, pools, c, last)
        def decode(p, t, pos, pools, c, state):
            return lm.decode_step(p, t, pos, pools, c, state)
        logits, pools, state = under(name, prefill, params, batch, pools,
                                     ctx(f"{key}.prefill", split),
                                     jnp.asarray(lengths) - 1)
        out[f"{arch}.{name}.0"] = np.asarray(logits)
        for k, v in state.items():
            out[f"{arch}.{name}.state0.{k}"] = np.asarray(v)
        for s in range(2):
            logits, pools, state = under(
                name, decode, params, jnp.asarray(data[f"lm.tokens{s + 1}"]),
                jnp.asarray(lengths) + n_pre + s, pools,
                ctx(f"{key}.decode{s}", split), state)
            out[f"{arch}.{name}.{s + 1}"] = np.asarray(logits)
        for k, v in state.items():
            out[f"{arch}.{name}.state1.{k}"] = np.asarray(v)
        if pools is not None:
            out[f"{arch}.{name}.k_pool"] = np.asarray(pools[0])
np.savez(out_path, **out)
"""


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, every family's weights, and the reference's process,
    started here so that it runs while the port's ranks do."""
    d = tmp_path_factory.mktemp("serve_mesh_families")
    inputs = str(d / "inputs.npz")
    cases.write_inputs(inputs)
    trees, paths = {}, {}
    for arch in cases.FAMILY_ARCHS:
        cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
        trees[arch] = jax.tree.map(np.asarray,
                                   JLM(cfg).init(jax.random.PRNGKey(0)))
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(params_from_jax(trees[arch]), paths[arch])
    ref = ReferenceRun(_REFERENCE, [inputs, str(d / "ref.npz"),
                                    json.dumps(cases.FAMILY_ARCHS)], d)
    yield types.SimpleNamespace(dir=d, inputs=inputs, params=paths,
                                trees=trees, ref=ref)
    ref.close()


@pytest.fixture(scope="module")
def ranks(setup):
    """Every mesh's ranks: {mesh name: [rank results]}."""
    return {name: run_ranks("torch_serve_cases:family_suite",
                            int(np.prod(shape)),
                            args=[setup.inputs, name, setup.params],
                            paths=[TESTS], timeout=WAIT_SECONDS)
            for name, (shape, _split) in cases.MESHES.items()}


@pytest.fixture(scope="module")
def reference(setup, ranks):
    setup.ref.wait()
    return dict(np.load(setup.dir / "ref.npz"))


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's one-rank path (no context) on the S = 1 tables, and the
    whole Mamba-2 block."""
    data = dict(np.load(setup.inputs))
    out = {arch: cases.run_family(data, arch, torch.load(
        setup.params[arch], weights_only=True), None, None)
        for arch in cases.FAMILY_ARCHS}
    out["blocks"] = cases.run_blocks(data, torch.load(
        setup.params[SSM], weights_only=True), 1)
    return out


def _rows(results, mesh, pick):
    """The global batch from the ranks: each data rank's rows (from its
    model rank 0; every model rank must return the same), or, unsplit,
    rank 0's (every rank the same)."""
    (D, M), split = cases.MESHES[mesh]
    for r, out in enumerate(results):
        anchor = results[(r // M) * M if split else 0]
        assert torch.equal(pick(out), pick(anchor)), (mesh, r)
    if not split:
        return pick(results[0])
    return torch.cat([pick(results[d * M]) for d in range(D)])


def _gather_state(results, mesh, arch, which, key):
    """The decode state ``key`` (after the prefill: ``which`` 0, after the
    last step: 1) of the whole batch from the ranks' shards: the model
    ranks' heads of ``ssm``, KV heads of ``cross_k`` / ``cross_v`` and conv
    channels (``x`` each rank's, ``B`` / ``C`` whole on every rank) side by
    side, the data ranks' rows one after another (unsplit: data rank 0's,
    every data rank the same)."""
    (D, M), split = cases.MESHES[mesh]
    cfg = cases.f32_smoke(arch)

    def cell(d):
        parts = [results[d * M + m][arch]["states"][which][key]
                 for m in range(M)]
        if key == "conv":
            d_in = dims(cfg)[0]
            dl = d_in // M
            for p in parts[1:]:
                assert torch.equal(p[..., dl:], parts[0][..., dl:])
            return torch.cat([p[..., :dl] for p in parts]
                             + [parts[0][..., dl:]], dim=-1)
        return torch.cat(parts, dim=2 if key == "ssm" else 3)
    cells = [cell(d) for d in range(D)]
    if not split:
        for c in cells[1:]:
            assert torch.equal(c, cells[0]), (mesh, arch, key)
        return cells[0]
    return torch.cat(cells, dim=1)


def _pool(results, arch):
    """The global pool: rank r's pages r-th."""
    return torch.cat([out[arch]["k_pool"] for out in results], dim=-4)


STATE_KEYS = {HYBRID: ("ssm", "conv"), SSM: ("ssm", "conv"),
              ENCDEC: ("cross_k", "cross_v")}


# ---------------------------------------------------------------- LMs


@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
@pytest.mark.parametrize("arch", cases.FAMILY_ARCHS)
def test_family_matches_the_reference_and_one_rank(arch, mesh, ranks,
                                                   reference, one_rank):
    """``LM.prefill`` of four prompts (24-100 tokens; llava's behind its
    16 patch embeddings, seamless's over 64 source frames) then two
    ``decode_step`` calls on the serving shards: the logits of every call
    within ``ONE_RANK_TOL`` (1e-6 but for zamba2) of their
    scale of the port's one-rank run and within 1e-5 of the reference's
    mesh run; the pools, gathered, within 1e-5 of the reference's."""
    res = ranks[mesh]
    for call in range(1 + cases.DECODE_STEPS):
        got = _rows(res, mesh, lambda out: out[arch]["logits"][call])
        assert _scaled(got, one_rank[arch]["logits"][call]) <= \
            ONE_RANK_TOL.get(arch, 1e-6), (arch, mesh, call)
        assert _scaled(got, reference[f"{arch}.{mesh}.{call}"]) <= 1e-5, (
            arch, mesh, call)
    if arch != SSM:
        assert _scaled(_pool(res, arch), reference[f"{arch}.{mesh}.k_pool"]
                       ) <= 1e-5


@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
@pytest.mark.parametrize("arch", sorted(STATE_KEYS))
def test_decode_state_gathers_to_one_rank_and_the_reference(
        arch, mesh, ranks, reference, one_rank):
    """Each rank's decode state is a layout (its rows, the recurrent
    families' heads and conv channels, encdec's KV heads): gathered over
    the ranks after the prefill and after the last step, it is within
    ``ONE_RANK_TOL`` of its scale of the port's one-rank state and within
    1e-5 of the reference's mesh run's (which keeps it whole over
    ``model``)."""
    for which in (0, 1):
        for key in STATE_KEYS[arch]:
            got = _gather_state(ranks[mesh], mesh, arch, which, key)
            assert _scaled(got, one_rank[arch]["states"][which][key]) <= \
                ONE_RANK_TOL.get(arch, 1e-6), (arch, mesh, which, key)
            want = reference[f"{arch}.{mesh}.state{which}.{key}"]
            assert got.shape == want.shape
            assert _scaled(got, want) <= 1e-5, (arch, mesh, which, key)


@pytest.mark.parametrize("tp", [2, 4])
def test_mamba_blocks_on_a_ranks_heads_match_the_whole_block(tp, ranks,
                                                             one_rank):
    """``mamba_block_train(return_state=True)`` over 40 tokens and
    ``mamba_block_decode`` of one more on each rank's heads of a (1, tp)
    mesh: every rank's output within 1e-6 of its scale of the whole
    block's (the same on every rank: the reduce over ``model``), and the
    rank's state, gathered, the whole block's."""
    res = ranks["12" if tp == 2 else "22"]
    cfg = cases.f32_smoke(SSM)
    d_in = dims(cfg)[0]
    dl = d_in // tp
    for call in ("train", "decode"):
        y1, h1, conv1 = one_rank["blocks"][call]
        outs = [r["blocks"][call] for r in res]
        assert len(outs) == tp
        for y, h, conv in outs:
            assert torch.equal(y, outs[0][0])
            assert h.shape[1] == h1.shape[1] // tp
            assert torch.equal(conv[..., dl:], outs[0][2][..., dl:])
        assert _scaled(outs[0][0], y1) <= 1e-6, call
        assert _scaled(torch.cat([o[1] for o in outs], dim=1), h1) <= 1e-6
        conv = torch.cat([o[2][..., :dl] for o in outs]
                         + [outs[0][2][..., dl:]], dim=-1)
        assert _scaled(conv, conv1) <= 1e-6, call


# ---------------------------------------------------------------- layout


def _mamba_parts(cfg, t, dim):
    """``w_in``'s z, x, B, C, dt columns (or the conv channels' x, B, C)
    along ``dim``, from the config's widths alone."""
    s = cfg.ssm
    d_in, nh, _cd = dims(cfg)
    gn = s.n_groups * s.d_state
    widths = ([d_in, d_in, gn, gn, nh] if t.shape[dim] == 2 * d_in + 2 * gn
              + nh else [d_in, gn, gn])
    return list(torch.split(t, widths, dim=dim))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_bridge_cuts_mamba_leaves_by_heads(arch, mesh_shape, setup):
    """``bridge.serving_shard_from_jax`` cuts every Mamba-2 leaf by the
    rank's heads: ``w_in``'s z, x and dt columns, ``conv_w`` / ``conv_b``'s
    x channels, ``A_log`` / ``D`` / ``dt_bias``, ``norm_w`` and ``w_out``'s
    rows are the model rank's block of each (so the model ranks' shards
    tile the leaf), B and C whole on every rank (one group); a data rank
    holds the same shard as the other data ranks."""
    cfg = cases.f32_smoke(arch)
    mesh = Mesh(mesh_shape, ("data", "model"))
    M = mesh_shape[1]
    full = params_from_jax(setup.trees[arch])
    shards = [serving_shard_from_jax(cfg, setup.trees[arch], mesh, r)
              for r in range(mesh.size)]
    names = [n for n in full if ".mamba." in n]
    assert len(names) == 8
    for name in names:
        leaf = name.rsplit(".", 1)[-1]
        for r, sh in enumerate(shards):
            m = r % M
            assert torch.equal(sh[name], shards[m][name])

            def block(t, dim):
                n = t.shape[dim] // M
                return t.narrow(dim, m * n, n)
            got = sh[name]
            if leaf in ("w_in", "conv_w", "conv_b"):
                want, parts = [], _mamba_parts(cfg, full[name], -1)
                for i, part in enumerate(parts):
                    whole = (leaf == "w_in" and i in (2, 3)) or (
                        leaf != "w_in" and i in (1, 2))
                    want.append(part if whole else block(part, -1))
                want = torch.cat(want, dim=-1)
            elif leaf == "w_out":
                want = block(full[name], -2)
            else:
                want = block(full[name], -1)
            assert torch.equal(got, want), (name, r)
            assert got.numel() < full[name].numel(), (name, r)


@pytest.mark.parametrize("arch", cases.FAMILY_ARCHS)
def test_no_rank_holds_a_whole_split_weight(arch, setup):
    """At (1, 2) every weight the serving rule splits over ``model`` (the
    attention heads, the SwiGLU's hidden dim, the vocabulary) and every
    Mamba-2 leaf is smaller on a rank than whole; ``w_in`` and ``conv_w``
    are not their contiguous halves (the reference's GSPMD cut)."""
    cfg = cases.f32_smoke(arch)
    mesh = Mesh((1, 2), ("data", "model"))
    full = params_from_jax(setup.trees[arch])
    places = serving_placements(cfg, full, mesh, 1)
    split = 0
    for name, t in full.items():
        spec = spec_for(name, tuple(t.shape), mesh)
        if "model" in spec or ".mamba." in name:
            shard = places[name].take(t)
            assert shard.numel() < t.numel(), name
            split += 1
        if name.rsplit(".", 1)[-1] in ("w_in", "conv_w"):
            half = t.shape[-1] // 2
            assert not torch.equal(places[name].take(t), t[..., half:])
    assert split >= 8


@pytest.mark.parametrize("groups,tp", [(1, 3), (2, 4)])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_a_model_axis_that_cannot_split_the_heads_is_refused(arch, groups,
                                                             tp):
    """A ``model`` axis that does not divide the Mamba-2 heads (8 in the
    smoke configs, over 3), or whose B / C groups are neither one nor a
    multiple of it (2 over 4), leaves a rank no share of the block: the
    serving cut and the LM's serving context raise, and no rank runs a
    whole block on a partial shard."""
    base = cases.f32_smoke(arch)
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, n_groups=groups))
    meta = dict(TLM(cfg, device="meta").named_parameters())
    with pytest.raises(ValueError, match="by heads"):
        serving_placements(cfg, meta, Mesh((1, tp), ("data", "model")), 0)
    with pytest.raises(ValueError, match="by heads"):
        TLM(cfg, device="meta")._serving_par(ParallelCtx(tp=tp))
    assert TLM(cfg, device="meta")._serving_par(ParallelCtx()) is None


@pytest.mark.parametrize("call", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", ["12", "22"])
@pytest.mark.parametrize("arch", cases.FAMILY_ARCHS)
def test_dry_run_counts_the_bytes_the_mesh_sends(arch, mesh, call, ranks):
    """``launch/dryrun.collective_bytes`` at the cases' own cfg, batch and
    mesh equals, by kind, the bytes every rank's collectives sent in the
    prefill (padded to T_PAD; llava's patch embeddings and seamless's
    encoder included) and in the first decode step."""
    shape, split = cases.MESHES[mesh]
    m = Mesh(shape, ("data", "model"))
    sh = ShapeConfig(call, cases.T_PAD if call == "prefill"
                     else max(cases.LENGTHS), len(cases.LENGTHS), call)
    plan = serve_plan(sh, m)
    assert plan.batch_sharded == split and plan.S == shape[1]
    want = dryrun.collective_bytes(cases.f32_smoke(arch), sh, m,
                                   {"kind": call, "plan": plan})
    assert want["total"] > 0
    for r, out in enumerate(ranks[mesh]):
        got = out[arch]["sent"][call]
        assert set(got) <= set(want), (r, got)
        for kind, nbytes in want.items():
            assert got.get(kind, 0.0) == pytest.approx(nbytes, rel=1e-12), (
                r, kind, got, want)
