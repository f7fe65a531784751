"""The port's serving over a mesh of gloo ranks against the reference's
``shard_map`` paths on forced host devices, on the CPU.

Each rank holds the pages of its stripe of frames (frame f on stripe
f % S, the ``ShardedKVCache`` contract) and its serving shard of the
weights; decode attention runs over its own pages and the (o, m, l)
partials are combined across the page group; MoE layers run the serving
2-D expert parallelism (experts over ``data``, their hidden dim over
``model``) where the mesh has a data axis, else the training EP.  The
port runs on 2 ranks at (1, 2) and on 4 at (2, 2), the batch split over
``data``, and at (2, 2) unsplit, the pages striped over every rank (the
reference's long_500k layout); its ranks are processes of
``repro_torch.launch.spawn.run_ranks`` (rank functions in
``tests/torch_serve_cases.py``).  The reference runs once, in its own
process on 4 forced host devices at XLA's optimisation level 0, every case
of this file in it.  Tables come from the port's ``ShardedKVCache`` (one
per data cell), weights from the reference's ``LM.init`` at seed 0 (the
port's through the bridge).

Tolerances: pools bit for bit where both packages copy the same values
(the op cases); the attention output of the op cases and the mesh run's
logits within 1e-6 of their scale of the port's one-rank run (the partials
summed in another order); the logits within 1e-5 of their scale of the
reference's (two packages' f32 products); the MoE blocks within 1e-6.
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
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.common import ParallelCtx, serving_ctx
from repro_torch.models.lm import LM
from repro_torch.models.page_ops import PageCtx, paged_attn_op

ROOT = Path(__file__).resolve().parents[1]
TESTS = str(ROOT / "tests")
sys.path.insert(0, TESTS)
try:
    import torch_serve_cases as cases
    from torch_reference_run import WAIT_SECONDS as TIMEOUT
    from torch_reference_run import ReferenceRun
finally:
    sys.path.remove(TESTS)

MOE = ("deepseek-v2-lite-16b", "dbrx-132b")

# The reference on 4 forced host devices: every op case under each mesh,
# the four LMs' prefill and decode steps on one device and at (1, 2) and
# (2, 2), and the MoE blocks (serving mode) on layer 0's experts, with the
# shared experts' own term.
_REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro import compat
from repro.configs import get_smoke_config
from repro.models import common
from repro.models.lm import LM
from repro.models.moe import _moe_shared, moe_block
from repro.models.transformer import PageCtx, paged_attn_op, prefill_write_op

inp, out_path = sys.argv[1], sys.argv[2]
data = dict(np.load(inp))
meta = json.load(open(inp + ".json"))
ptok, fp = meta["geo"]
npr, lengths = meta["pages_per_rank"], meta["lengths"]
ops = {"gqa": (4, 2, 16, 16), "mla": (4, 1, 40, 32)}
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

for name, (shape, split) in meta["meshes"].items():
    for op, (H, n_kv, dk, dv) in ops.items():
        NP = npr * int(np.prod(shape))
        kp = jnp.zeros((NP, ptok, n_kv, dk), jnp.float32)
        vp = jnp.zeros((NP, ptok, n_kv, dv), jnp.float32)
        g = {k: jnp.asarray(data[f"op.{op}.{k}"])
             for k in ("q", "k_new", "v_new", "k_seq", "v_seq")}
        def run(g, kp, vp, pre, dec):
            kp, vp = prefill_write_op(g["k_seq"], g["v_seq"], kp, vp, pre)
            return paged_attn_op(g["q"], g["k_new"], g["v_new"], kp, vp, dec,
                                 scale=dk ** -0.5)
        o, kp, vp = under(name, run, g, kp, vp, ctx(f"{name}.prefill", split),
                          ctx(f"{name}.decode0", split))
        for k, v in (("o", o), ("k_pool", kp), ("v_pool", vp)):
            out[f"ops.{name}.{op}.{k}"] = np.asarray(v)

for arch in json.loads(sys.argv[3]):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lm = LM(cfg)
    params = lm.init(jax.random.PRNGKey(0))
    for name in ("one", "12", "22"):
        pages = npr * (4 if name == "one"
                       else int(np.prod(meta["meshes"][name][0])))
        pools = tuple(jnp.zeros(s.shape, jnp.float32)
                      for s in lm.pool_shapes(pages, ptok))
        split = name == "one" or meta["meshes"][name][1]
        def prefill(p, t, pools, c, last):
            return lm.prefill(p, {"tokens": t}, pools, c, last)[:2]
        def decode(p, t, pos, pools, c):
            return lm.decode_step(p, t, pos, pools, c)[:2]
        logits, pools = under(name, prefill, params,
                              jnp.asarray(data["lm.tokens0"]), pools,
                              ctx(f"{name}.prefill", split),
                              jnp.asarray(lengths) - 1)
        out[f"lm.{arch}.{name}.0"] = np.asarray(logits)
        for s in range(2):
            logits, pools = under(name, decode, params,
                                  jnp.asarray(data[f"lm.tokens{s + 1}"]),
                                  jnp.asarray(lengths) + s, pools,
                                  ctx(f"{name}.decode{s}", split))
            out[f"lm.{arch}.{name}.{s + 1}"] = np.asarray(logits)
        out[f"lm.{arch}.{name}.k_pool"] = np.asarray(pools[0])
    if cfg.moe is None:
        continue
    p = jax.tree.map(lambda t: t[0], params["decoder"]["moe"])
    for T in (1, 8):
        x = jnp.asarray(data[f"moe.{arch}.x{T}"])
        for name in ("one", "12", "22"):
            y = under(name, lambda p, x: moe_block(cfg, p, x)[0], p, x)
            out[f"moe.{arch}.{name}.{T}"] = np.asarray(y)
        if cfg.moe.n_shared:
            out[f"moe.{arch}.shared.{T}"] = np.asarray(
                jax.jit(lambda p, x: _moe_shared(cfg, p, x))(p, x))
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
    """The inputs, every arch's weights, and the reference's process,
    started here so that it runs while the port's ranks do."""
    d = tmp_path_factory.mktemp("serve_mesh")
    inputs = str(d / "inputs.npz")
    cases.write_inputs(inputs)
    trees, paths = {}, {}
    for arch in cases.LM_ARCHS:
        cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
        trees[arch] = jax.tree.map(np.asarray,
                                   JLM(cfg).init(jax.random.PRNGKey(0)))
        paths[arch] = str(d / f"{arch}.pt")
        torch.save(params_from_jax(trees[arch]), paths[arch])
    ref = ReferenceRun(_REFERENCE, [inputs, d / "ref.npz",
                                    json.dumps(cases.LM_ARCHS)], d)
    yield types.SimpleNamespace(dir=d, inputs=inputs, params=paths,
                                trees=trees, ref=ref)
    ref.close()


@pytest.fixture(scope="module")
def reference(setup, ranks):
    setup.ref.wait()
    return dict(np.load(setup.dir / "ref.npz"))


@pytest.fixture(scope="module")
def ranks(setup):
    """Every mesh's ranks: {mesh name: [rank results]}."""
    return {name: run_ranks("torch_serve_cases:suite",
                            int(np.prod(shape)),
                            args=[setup.inputs, name, setup.params],
                            paths=[TESTS], timeout=TIMEOUT)
            for name, (shape, _split) in cases.MESHES.items()}


@pytest.fixture(scope="module")
def one_rank(setup):
    """The port's one-rank path (no context) on the S = 1 tables."""
    data = dict(np.load(setup.inputs))
    out = {"ops": {op: cases.run_ops(data, op, None, None)
                   for op in cases.OP_SHAPES}, "lm": {}, "moe": {}}
    for arch in cases.LM_ARCHS:
        w = torch.load(setup.params[arch], weights_only=True)
        out["lm"][arch] = cases.run_lm(data, arch, w, None, None)
        if arch in MOE:
            out["moe"][arch] = cases.run_moe(data, arch, w, None, None)
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


def _pool(results, pick):
    """The global pool: rank r's pages r-th (the reference's page dim over
    (data, model), data major)."""
    return torch.cat([pick(out) for out in results], dim=-4)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("op", sorted(cases.OP_SHAPES))
@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
def test_paged_ops_match_the_reference_and_one_rank(mesh, op, ranks,
                                                    reference, one_rank):
    """``prefill_write_op`` then ``paged_attn_op`` (one decode token) on
    each rank's stripe: the pools, gathered over the ranks, bit for bit
    the reference's; the combined output within 1e-6 of its scale of the
    reference's under ``shard_map`` and of the port's one-rank path.
    ``mla``: the latent pools' widths (40 / 32 over one KV head)."""
    res = ranks[mesh]
    o = _rows(res, mesh, lambda out: out["ops"][op][0])
    key = f"ops.{mesh}.{op}"
    assert _scaled(o, reference[f"{key}.o"]) <= 1e-6
    assert _scaled(o, one_rank["ops"][op][0]) <= 1e-6
    for i, part in ((1, "k_pool"), (2, "v_pool")):
        pool = _pool(res, lambda out: out["ops"][op][i])
        np.testing.assert_array_equal(pool.numpy(), reference[f"{key}.{part}"])
    # Rows whose sequence has no frame on a rank: that rank's partials add
    # exact zeros (row 2's 24 tokens live on stripe 0 alone).
    assert cases.LENGTHS[2] + 1 <= cases.GEO.frame_pages * cases.GEO.page_tokens


# ---------------------------------------------------------------- LMs

# Where the reference's mesh run is at fault (ROADMAP Queue 3), the port is
# held to the reference's one-device run: its MoE serving at (1, 2) takes
# the training EP's wrapped entries, and its 2-D EP decode at (2, 2) adds
# deepseek's shared experts once per data rank.
def _oracle(arch, mesh, call):
    if arch in MOE and mesh == "12":
        return "one"
    if arch == "deepseek-v2-lite-16b" and mesh == "22" and call > 0:
        return "one"
    return mesh


@pytest.mark.parametrize("mesh", ["12", "22"])
@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_lm_matches_the_reference_and_one_rank(arch, mesh, ranks, reference,
                                               one_rank):
    """``LM.prefill`` of four prompts (24-100 tokens: 1-4 frames of 32, so
    some rows have no page on a stripe) then two ``decode_step`` calls, on
    the serving shards: the logits of every call within 1e-6 of their
    scale of the port's one-rank run and within 1e-5 of the reference's
    (its mesh run, or its one-device run where the mesh run is at fault);
    the pools, gathered, within 1e-5 of the reference's mesh run's."""
    res = ranks[mesh]
    for call in range(1 + cases.DECODE_STEPS):
        got = _rows(res, mesh, lambda out: out["lm"][arch]["logits"][call])
        assert _scaled(got, one_rank["lm"][arch]["logits"][call]) <= 1e-6
        want = reference[f"lm.{arch}.{_oracle(arch, mesh, call)}.{call}"]
        assert _scaled(got, want) <= 1e-5, (arch, mesh, call)
    pool = _pool(res, lambda out: out["lm"][arch]["k_pool"])
    ref_pool = reference[f"lm.{arch}.{mesh}.k_pool"]
    if _oracle(arch, mesh, 1) == mesh:
        assert _scaled(pool, ref_pool) <= 1e-5


@pytest.mark.parametrize("call", ["prefill", "decode"])
@pytest.mark.parametrize("mesh", ["12", "22"])
@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_dry_run_counts_the_bytes_the_mesh_sends(arch, mesh, call, ranks):
    """``launch/dryrun.collective_bytes`` at the LM cases' own cfg, batch
    and mesh equals, by kind, the bytes every rank's collectives sent in
    the prefill of the four prompts (padded to T_PAD) and in the first
    decode step (``torch_dist_cases.Collectives``, wrapping every
    ``torch.distributed`` collective the port calls)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import serve_plan
    shape, split = cases.MESHES[mesh]
    m = Mesh(shape, ("data", "model"))
    sh = ShapeConfig(call, cases.T_PAD if call == "prefill"
                     else max(cases.LENGTHS), len(cases.LENGTHS), call)
    plan = serve_plan(sh, m)
    assert plan.batch_sharded == split and plan.S == shape[1]
    want = dryrun.collective_bytes(cases.f32_smoke(arch), sh, m,
                                   {"kind": call, "plan": plan})
    for r, out in enumerate(ranks[mesh]):
        got = out["lm"][arch]["sent"][call]
        assert set(got) <= set(want), (r, got)
        for kind, nbytes in want.items():
            assert got.get(kind, 0.0) == pytest.approx(nbytes, rel=1e-12), (
                r, kind, got, want)


def test_moe_blocks_match_one_device(ranks, reference, one_rank):
    """The serving MoE block on layer 0's experts at T = 1 (decode: the 2-D
    EP's gather and dense-masked pass) and T = 8 (prefill: the experts'
    weights gathered over ``data``) at (2, 2), and the training EP at
    (1, 2): within 1e-6 of the port's one device and of the reference's
    one device."""
    for arch in MOE:
        for mesh in ("12", "22"):
            for T in (1, 8):
                got = _rows(ranks[mesh], mesh,
                            lambda out: out["moe"][arch][T])
                assert _scaled(got, one_rank["moe"][arch][T]) <= 1e-6
                assert _scaled(got, reference[f"moe.{arch}.one.{T}"]) <= 1e-6


def test_reference_ep2d_decode_adds_shared_experts_per_data_rank(
        ranks, reference):
    """A reference fault the port does not copy (ROADMAP Queue 3): its 2-D
    EP decode (``repro/models/moe.py:269-270``) adds the shared experts on
    every (data, model) cell, then sums over ``data`` too, where the shared
    weights are replicated: at (2, 2) deepseek-v2-lite's decode equals its
    one-device output plus (data - 1) = 1 more shared term, while its
    prefill (T = 8, summed over ``model`` only) and dbrx (no shared
    experts) match one device.  The port adds them once and follows the
    one-device output."""
    ds = "deepseek-v2-lite-16b"
    one, mesh = reference[f"moe.{ds}.one.1"], reference[f"moe.{ds}.22.1"]
    shared = reference[f"moe.{ds}.shared.1"]
    assert _scaled(mesh, one) > 1e-2
    assert _scaled(mesh, one + (2 - 1) * shared) <= 1e-6
    assert _scaled(reference[f"moe.{ds}.22.8"],
                   reference[f"moe.{ds}.one.8"]) <= 1e-6
    for T in (1, 8):
        assert _scaled(reference[f"moe.dbrx-132b.22.{T}"],
                       reference[f"moe.dbrx-132b.one.{T}"]) <= 1e-6
    got = _rows(ranks["22"], "22", lambda out: out["moe"][ds][1])
    assert _scaled(got, one) <= 1e-6


def test_reference_serving_at_one_by_two_takes_the_training_eps_wrapped_entries(
        ranks, reference):
    """At (1, 2) the 2-D geometry needs a data axis, so the reference's
    serving MoE runs its training EP (``repro/models/moe.py:168`` onward),
    whose negative expert offsets wrap other ranks' entries into a rank's
    experts (ROADMAP Queue 3): its output differs from its one
    device's at decode and at prefill, for both models.  The port's (1, 2)
    serving keeps each rank's own experts and follows one device."""
    for arch in MOE:
        for T in (1, 8):
            want = reference[f"moe.{arch}.one.{T}"]
            assert _scaled(reference[f"moe.{arch}.12.{T}"], want) > 1e-3
            got = _rows(ranks["12"], "12", lambda out: out["moe"][arch][T])
            assert _scaled(got, want) <= 1e-6


# ---------------------------------------------------------------- contract


def test_one_rank_path_is_unchanged(setup):
    """A one-rank mesh has no context (the one-device path), and a context
    of one rank runs it bit for bit: the LM's logits and pools with
    ``par=ParallelCtx()`` equal those without."""
    assert serving_ctx(Mesh((1, 1), ("data", "model")), 0) is None
    data = dict(np.load(setup.inputs))
    arch = "qwen2.5-3b"
    w = torch.load(setup.params[arch], weights_only=True)
    a = cases.run_lm(data, arch, w, None, None)
    lm = LM(cases.f32_smoke(arch))
    lm.load_state_dict(w)
    pools = [torch.zeros((s[0], cases.pages_on_rank(None), *s[2:]))
             for s, _ in lm.pool_shapes(cases.pages_on_rank(None), 8)]
    logits, pools, _ = lm.prefill(
        {"tokens": torch.from_numpy(data["lm.tokens0"])}, pools,
        cases._ctx(data, "one.prefill"), torch.tensor(cases.LENGTHS) - 1,
        par=ParallelCtx())
    assert torch.equal(logits, a["logits"][0])


def test_fused_staging_has_no_mesh_path():
    """Staged pages (``PageCtx.slots``) on more than one page shard are
    refused, as the reference does."""
    ctx = PageCtx(tables=torch.zeros((1, 2, 4), dtype=torch.int32),
                  ntok=torch.zeros((1, 2, 4), dtype=torch.int32),
                  wpage=torch.full((1, 2), -1, dtype=torch.int32),
                  wslot=torch.zeros(1, dtype=torch.int32),
                  slots=torch.full((1, 2, 4), -1, dtype=torch.int32))
    par = ParallelCtx(page_shards=2, page_rank=1)
    pool = torch.zeros((4, 8, 1, 32))
    with pytest.raises(NotImplementedError, match="slots"):
        paged_attn_op(torch.zeros((1, 1, 32)), torch.zeros((1, 1, 32)),
                      torch.zeros((1, 1, 32)), pool, pool, ctx, scale=1.0,
                      par=par)


def test_bridge_cuts_a_serving_shard(setup):
    """``bridge.serving_shard_from_jax`` of the reference's tree is the
    rank's serving shard: at (2, 2) deepseek's experts split over ``data``
    and their hidden dim over ``model``, attention heads over ``model``,
    the vocabulary over ``model``, norms whole; the shards of the four
    ranks tile each leaf."""
    arch = "deepseek-v2-lite-16b"
    cfg = cases.f32_smoke(arch)
    mesh = Mesh((2, 2), ("data", "model"))
    full = params_from_jax(setup.trees[arch])
    shards = [serving_shard_from_jax(cfg, setup.trees[arch], mesh, r)
              for r in range(4)]
    E, d, fe = full["decoder.moe.w_gate"].shape[1:]
    assert shards[3]["decoder.moe.w_gate"].shape[1:] == (E // 2, d, fe // 2)
    assert torch.equal(shards[3]["decoder.moe.w_gate"],
                       full["decoder.moe.w_gate"][:, E // 2:, :, fe // 2:])
    assert shards[1]["decoder.attn.wq"].shape[2] == cfg.n_heads // 2
    assert shards[1]["embed"].shape[0] == cfg.vocab_size // 2
    assert torch.equal(shards[2]["decoder.ln1"], full["decoder.ln1"])
    total = sum(s["decoder.moe.w_down"].numel() for s in shards)
    assert total == full["decoder.moe.w_down"].numel()
