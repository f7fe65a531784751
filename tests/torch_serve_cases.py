"""Rank functions and inputs of the port's serving-over-a-mesh tests.

``tests/test_torch_serve_mesh.py`` writes every case's inputs once
(:func:`write_inputs`: tables from the port's ``ShardedKVCache``, values
from numpy seeds) into one ``.npz`` beside a JSON description; the
reference's process and the port's ranks (``launch/spawn.run_ranks``,
:func:`suite`) read them.  No JAX here: the ranks import only torch and
the port.
"""

import dataclasses
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import PoolGeometry
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (
    serving_lm,
    serving_placements,
    serving_shard,
)
from repro_torch.models.common import serving_ctx
from repro_torch.models.moe import moe_block
from repro_torch.models.page_ops import PageCtx, paged_attn_op, prefill_write_op
from repro_torch.serving.kv_cache import ShardedKVCache
from torch_dist_cases import Collectives

GEO = PoolGeometry(page_tokens=8, frame_pages=4)
PAGES_PER_RANK = 32
LENGTHS = (40, 72, 24, 100)       # prompt tokens of the four rows
T_PAD = 104                       # the longest, padded to a page multiple
DECODE_STEPS = 2
# name -> (mesh shape, batch split over the data axes)
MESHES = {"12": ((1, 2), True), "22": ((2, 2), True),
          "22u": ((2, 2), False)}
# Op cases: (H, n_kv, key width, value width); "mla" is the smoke
# deepseek's latent pools (kv_lora 32 + rope 8 over one KV head).
OP_SHAPES = {"gqa": (4, 2, 16, 16), "mla": (4, 1, 40, 32)}
LM_ARCHS = ("qwen2.5-3b", "qwen3-8b", "deepseek-v2-lite-16b", "dbrx-132b")


def f32_smoke(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def tables_for(mesh_name):
    """The prefill and per-step decode tables of LENGTHS' four rows as the
    reference's PageCtx takes them ([B, S, mpps]): one ShardedKVCache per
    data cell (the batch split over ``data``: a cell's rows' frames
    striped over ``model``; unsplit: one cache over every rank), each
    shard a rank's PAGES_PER_RANK pages.  ``mesh_name`` None: the one-rank
    layout (S = 1)."""
    if mesh_name is None:
        cells, S = 1, 1
    else:
        (D, M), split = MESHES[mesh_name]
        cells, S = (D, M) if split else (1, D * M)
    ftok = GEO.frame_pages * GEO.page_tokens
    frames = -(-(max(LENGTHS) + DECODE_STEPS) // ftok)
    mpps = -(-frames // S) * GEO.frame_pages
    caches = [ShardedKVCache(GEO, pages_on_rank(mesh_name), S)
              for _ in range(cells)]
    per = len(LENGTHS) // cells
    rows = [list(range(c * per, (c + 1) * per)) for c in range(cells)]
    for i, n in enumerate(LENGTHS):
        caches[i // per].allocate(i, n)

    def pack():
        parts = [caches[c].pack_ctx(rows[c], mpps) for c in range(cells)]
        return {k: torch.cat([getattr(p, k) for p in parts]).numpy()
                for k in ("tables", "ntok", "wpage", "wslot")}
    out = {"prefill": pack(), "decode": []}
    for _ in range(DECODE_STEPS):
        for i in range(len(LENGTHS)):
            caches[i // per].append(i)
        out["decode"].append(pack())
    return out


def write_inputs(path):
    """Every case's inputs into ``path`` (.npz) and ``path``.json."""
    arrays, meta = {}, {"meshes": MESHES, "geo": [GEO.page_tokens,
                                                 GEO.frame_pages],
                        "pages_per_rank": PAGES_PER_RANK,
                        "lengths": LENGTHS, "t_pad": T_PAD}
    for name in (None, *MESHES):
        t = tables_for(name)
        key = name or "one"
        for k, v in t["prefill"].items():
            arrays[f"{key}.prefill.{k}"] = v
        for s, step in enumerate(t["decode"]):
            for k, v in step.items():
                arrays[f"{key}.decode{s}.{k}"] = v
    rng = np.random.default_rng(0)
    B = len(LENGTHS)
    for op, (H, n_kv, dk, dv) in OP_SHAPES.items():
        arrays[f"op.{op}.q"] = rng.standard_normal((B, H, dk), np.float32)
        for k, d in (("k", dk), ("v", dv)):
            arrays[f"op.{op}.{k}_new"] = rng.standard_normal(
                (B, n_kv, d), np.float32)
            arrays[f"op.{op}.{k}_seq"] = rng.standard_normal(
                (B, T_PAD, n_kv, d), np.float32)
    for s in range(1 + DECODE_STEPS):
        arrays[f"lm.tokens{s}"] = rng.integers(
            0, 512, (B, T_PAD) if s == 0 else (B,)).astype(np.int32)
    for arch in ("deepseek-v2-lite-16b", "dbrx-132b"):
        for T in (1, 8):
            arrays[f"moe.{arch}.x{T}"] = rng.standard_normal(
                (B, T, f32_smoke(arch).d_model), np.float32)
    np.savez(path, **arrays)
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f)


def _ctx(data, key):
    return PageCtx(**{k: torch.from_numpy(data[f"{key}.{k}"])
                      for k in ("tables", "ntok", "wpage", "wslot")},
                   frame_pages=GEO.frame_pages)


def pages_on_rank(mesh_name):
    """Pages of a rank's pool: PAGES_PER_RANK on each rank of a mesh, four
    times that on the one rank (``mesh_name`` None)."""
    return PAGES_PER_RANK * (4 if mesh_name is None else 1)


def run_ops(data, op, mesh_name, par):
    """The prefill write, then one decode step's write and paged attention
    of op case ``op`` on this rank (``par`` None: the one-rank path over
    the S = 1 tables): (o of this rank's rows, k_pool, v_pool)."""
    H, n_kv, dk, dv = OP_SHAPES[op]
    key = mesh_name or "one"
    npages = pages_on_rank(mesh_name)
    ptok = GEO.page_tokens
    kp = torch.zeros((npages, ptok, n_kv, dk))
    vp = torch.zeros((npages, ptok, n_kv, dv))
    g = {k: torch.from_numpy(data[f"op.{op}.{k}"])
         for k in ("q", "k_new", "v_new", "k_seq", "v_seq")}
    rows = par.rows if par is not None else (lambda t: t)
    pre = _ctx(data, f"{key}.prefill").rows(par)
    prefill_write_op(rows(g["k_seq"]), rows(g["v_seq"]), kp, vp, pre,
                     par=par)
    dec = _ctx(data, f"{key}.decode0").rows(par)
    o = paged_attn_op(rows(g["q"]), rows(g["k_new"]), rows(g["v_new"]), kp,
                      vp, dec, scale=dk ** -0.5, par=par)
    return o, kp, vp


def run_lm(data, arch, params, mesh_name, par):
    """Prefill of the four prompts, then DECODE_STEPS decode steps fed the
    given tokens, on this rank's LM (``par`` None: the whole LM over the
    one-rank tables).  Returns the logits of each call (this rank's rows),
    the pools, and the bytes this rank's collectives sent in the prefill
    and in the first decode step (``torch_dist_cases.Collectives``)."""
    from repro_torch.models.lm import LM
    cfg = f32_smoke(arch)
    key = mesh_name or "one"
    if par is None:
        lm = LM(cfg)
        lm.load_state_dict(params)
    else:
        mesh = Mesh(MESHES[mesh_name][0], ("data", "model"))
        lm = serving_lm(cfg, serving_shard(cfg, params, mesh,
                                           dist.get_rank()))
    npages = pages_on_rank(mesh_name)
    pools = [torch.zeros((s[0], npages, *s[2:]), dtype=torch.float32)
             for s, _dt in lm.pool_shapes(npages, GEO.page_tokens)]
    tokens = torch.from_numpy(data["lm.tokens0"])
    last = torch.tensor(LENGTHS) - 1
    with Collectives() as sent_prefill:
        logits, pools, _ = lm.prefill({"tokens": tokens}, pools,
                                      _ctx(data, f"{key}.prefill"), last,
                                      par=par)
    out, sent = [logits], {"prefill": sent_prefill.sent()}
    for s in range(DECODE_STEPS):
        pos = torch.tensor(LENGTHS) + s
        with Collectives() as sent_step:
            logits, pools, _ = lm.decode_step(
                torch.from_numpy(data[f"lm.tokens{s + 1}"]), pos, pools,
                _ctx(data, f"{key}.decode{s}"), par=par)
        sent.setdefault("decode", sent_step.sent())
        out.append(logits)
    return {"logits": out, "k_pool": pools[0], "v_pool": pools[1],
            "sent": sent}


def moe_layer(params):
    """Layer 0 of the decoder's MoE weights, as the blocks take them."""
    pre = "decoder.moe."
    return {n[len(pre):]: t[0] for n, t in params.items()
            if n.startswith(pre)}


def run_moe(data, arch, params, mesh_name, par):
    """``moe_block`` (serving) on layer 0's experts at T = 1 and 8: y of
    this rank's rows (``par`` None: one device)."""
    cfg = f32_smoke(arch)
    p = moe_layer(params)
    if par is not None:
        mesh = Mesh(MESHES[mesh_name][0], ("data", "model"))
        places = serving_placements(cfg, {f"moe.{n}": t for n, t in
                                          p.items()}, mesh, dist.get_rank())
        p = {n: places[f"moe.{n}"].take(t).contiguous() for n, t in p.items()}
    out = {}
    for T in (1, 8):
        x = torch.from_numpy(data[f"moe.{arch}.x{T}"])
        x = x if par is None else par.rows(x)
        out[T] = moe_block(cfg, p, x, par)[0]
    return out


def suite(path, mesh_name, params):
    """Every case at ``mesh_name`` on this rank: the op cases, the four
    LMs (weights from ``params[arch]``) and the MoE blocks."""
    torch.set_num_threads(1)
    data = dict(np.load(path))
    mesh = Mesh(MESHES[mesh_name][0], ("data", "model"))
    par = serving_ctx(mesh, dist.get_rank(), MESHES[mesh_name][1])
    out = {"ops": {op: run_ops(data, op, mesh_name, par)
                   for op in OP_SHAPES}, "lm": {}, "moe": {}}
    if not MESHES[mesh_name][1]:
        return out
    for arch in LM_ARCHS:
        w = torch.load(params[arch], weights_only=True)
        out["lm"][arch] = run_lm(data, arch, w, mesh_name, par)
        if arch in ("deepseek-v2-lite-16b", "dbrx-132b"):
            out["moe"][arch] = run_moe(data, arch, w, mesh_name, par)
    return out
