"""Rank functions and inputs of the port's serving-over-a-mesh tests.

``tests/test_torch_serve_mesh.py`` and
``tests/test_torch_serve_mesh_families.py`` write every case's inputs
once (:func:`write_inputs`: tables from the port's ``ShardedKVCache``,
values from numpy seeds) into one ``.npz`` beside a JSON description; the
reference's process and the port's ranks (``launch/spawn.run_ranks``,
:func:`suite`, :func:`family_suite`) read them.  No JAX here: the ranks
import only torch and the port.
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
BLOCK_T = 40                      # a Mamba-2 block case's prefill length
DECODE_STEPS = 2
# name -> (mesh shape, batch split over the data axes)
MESHES = {"12": ((1, 2), True), "22": ((2, 2), True),
          "22u": ((2, 2), False)}
# Op cases: (H, n_kv, key width, value width); "mla" is the smoke
# deepseek's latent pools (kv_lora 32 + rope 8 over one KV head).
OP_SHAPES = {"gqa": (4, 2, 16, 16), "mla": (4, 1, 40, 32)}
LM_ARCHS = ("qwen2.5-3b", "qwen3-8b", "deepseek-v2-lite-16b", "dbrx-132b")
# The hybrid, ssm, encdec and vlm families (their smoke configs in f32).
FAMILY_ARCHS = ("zamba2-1.2b", "mamba2-1.3b", "seamless-m4t-large-v2",
                "llava-next-mistral-7b")
VLM = "llava-next-mistral-7b"


def f32_smoke(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def prefix_tokens(arch):
    """Positions in front of the prompt's tokens: vlm's patch embeddings."""
    return f32_smoke(arch).frontend_tokens if arch == VLM else 0


def tables_for(mesh_name, lengths=LENGTHS):
    """The prefill and per-step decode tables of ``lengths``' four rows as
    the reference's PageCtx takes them ([B, S, mpps]): one ShardedKVCache
    per data cell (the batch split over ``data``: a cell's rows' frames
    striped over ``model``; unsplit: one cache over every rank), each
    shard a rank's PAGES_PER_RANK pages.  ``mesh_name`` None: the one-rank
    layout (S = 1)."""
    if mesh_name is None:
        cells, S = 1, 1
    else:
        (D, M), split = MESHES[mesh_name]
        cells, S = (D, M) if split else (1, D * M)
    ftok = GEO.frame_pages * GEO.page_tokens
    frames = -(-(max(lengths) + DECODE_STEPS) // ftok)
    mpps = -(-frames // S) * GEO.frame_pages
    caches = [ShardedKVCache(GEO, pages_on_rank(mesh_name), S)
              for _ in range(cells)]
    per = len(lengths) // cells
    rows = [list(range(c * per, (c + 1) * per)) for c in range(cells)]
    for i, n in enumerate(lengths):
        caches[i // per].allocate(i, n)

    def pack():
        parts = [caches[c].pack_ctx(rows[c], mpps) for c in range(cells)]
        return {k: torch.cat([getattr(p, k) for p in parts]).numpy()
                for k in ("tables", "ntok", "wpage", "wslot")}
    out = {"prefill": pack(), "decode": []}
    for _ in range(DECODE_STEPS):
        for i in range(len(lengths)):
            caches[i // per].append(i)
        out["decode"].append(pack())
    return out


def write_inputs(path):
    """Every case's inputs into ``path`` (.npz) and ``path``.json."""
    arrays, meta = {}, {"meshes": MESHES, "geo": [GEO.page_tokens,
                                                 GEO.frame_pages],
                        "pages_per_rank": PAGES_PER_RANK,
                        "lengths": LENGTHS, "t_pad": T_PAD}
    vlm_lengths = tuple(n + prefix_tokens(VLM) for n in LENGTHS)
    for name in (None, *MESHES):
        for pre, lengths in (("", LENGTHS), ("vlm.", vlm_lengths)):
            t = tables_for(name, lengths)
            key = pre + (name or "one")
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
    # The families' frontends and a Mamba-2 block's inputs.
    B, d = len(LENGTHS), f32_smoke(VLM).d_model
    arrays["fam.patch_embeds"] = rng.standard_normal(
        (B, prefix_tokens(VLM), d), np.float32)
    enc = f32_smoke("seamless-m4t-large-v2")
    arrays["fam.src_embeds"] = rng.standard_normal(
        (B, enc.encdec.source_len, enc.d_model), np.float32)
    arrays["block.x"] = rng.standard_normal((B, BLOCK_T, d), np.float32)
    arrays["block.x1"] = rng.standard_normal((B, 1, d), np.float32)
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


# ------------------------------------------------------- hybrid ssm encdec vlm


def family_batch(data, arch):
    """The prefill batch of ``arch``: the tokens, and vlm's patch / encdec's
    source embeddings (global rows)."""
    batch = {"tokens": torch.from_numpy(data["lm.tokens0"])}
    if arch == VLM:
        batch["patch_embeds"] = torch.from_numpy(data["fam.patch_embeds"])
    if f32_smoke(arch).family == "encdec":
        batch["src_embeds"] = torch.from_numpy(data["fam.src_embeds"])
    return batch


def run_family(data, arch, params, mesh_name, par):
    """:func:`run_lm` for a family of FAMILY_ARCHS: prefill of the four
    prompts (vlm's behind its patch embeddings, encdec's over its source
    frames), then DECODE_STEPS decode steps.  Returns the logits of each
    call, this rank's pools, its decode state after the prefill and after
    the last step, and the bytes its collectives sent."""
    from repro_torch.models.lm import LM
    cfg = f32_smoke(arch)
    key = ("vlm." if arch == VLM else "") + (mesh_name or "one")
    if par is None:
        lm = LM(cfg)
        lm.load_state_dict(params)
    else:
        mesh = Mesh(MESHES[mesh_name][0], ("data", "model"))
        lm = serving_lm(cfg, serving_shard(cfg, params, mesh,
                                           dist.get_rank()))
    npages = pages_on_rank(mesh_name)
    shapes = lm.pool_shapes(npages, GEO.page_tokens)
    pools = None if shapes is None else [
        torch.zeros((s[0], npages, *s[2:]), dtype=torch.float32)
        for s, _dt in shapes]
    last = torch.tensor(LENGTHS) - 1
    with Collectives() as sent_prefill:
        logits, pools, state = lm.prefill(
            family_batch(data, arch), pools, _ctx(data, f"{key}.prefill"),
            last, par=par)
    out, sent = [logits], {"prefill": sent_prefill.sent()}
    states = [dict(state)]
    for s in range(DECODE_STEPS):
        pos = torch.tensor(LENGTHS) + prefix_tokens(arch) + s
        with Collectives() as sent_step:
            logits, pools, state = lm.decode_step(
                torch.from_numpy(data[f"lm.tokens{s + 1}"]), pos, pools,
                _ctx(data, f"{key}.decode{s}"), state, par=par)
        sent.setdefault("decode", sent_step.sent())
        out.append(logits)
    states.append(dict(state))
    return {"logits": out, "k_pool": None if pools is None else pools[0],
            "states": states, "sent": sent}


def mamba_layer(params, prefix="decoder.mamba."):
    """Layer 0 of the stack's Mamba-2 weights (whole), as the blocks take
    them."""
    return {n[len(prefix):]: t[0] for n, t in params.items()
            if n.startswith(prefix)}


def run_blocks(data, params, tp):
    """``mamba_block_train(return_state=True)`` over BLOCK_T tokens, then
    ``mamba_block_decode`` of one token from that state, on layer 0 of the
    smoke mamba2's weights at this rank's heads of a (1, ``tp``) mesh
    (``tp`` 1: the whole block, no context): (y, h, conv) of each."""
    from repro_torch.launch.sharding import head_cut
    from repro_torch.models.mamba2 import mamba_block_decode, mamba_block_train
    cfg = f32_smoke("mamba2-1.3b")
    p = mamba_layer(params)
    par = None
    if tp > 1:
        mesh = Mesh((1, tp), ("data", "model"))
        par = serving_ctx(mesh, dist.get_rank())
        p = {n: head_cut(cfg, f"mamba.{n}", t.shape, mesh,
                         dist.get_rank()).take(t).contiguous()
             for n, t in p.items()}
    x = torch.from_numpy(data["block.x"])
    y, (h, conv) = mamba_block_train(cfg, p, x, return_state=True, par=par)
    y1, h1, conv1 = mamba_block_decode(
        cfg, p, torch.from_numpy(data["block.x1"]), h, conv, par)
    return {"train": (y, h, conv), "decode": (y1, h1, conv1)}


def family_suite(path, mesh_name, params):
    """Every family case at ``mesh_name`` on this rank: the four families'
    LMs (weights from ``params[arch]``) and, on a split mesh, the Mamba-2
    block cases at a model axis of the world's size."""
    torch.set_num_threads(1)
    data = dict(np.load(path))
    mesh = Mesh(MESHES[mesh_name][0], ("data", "model"))
    par = serving_ctx(mesh, dist.get_rank(), MESHES[mesh_name][1])
    out = {arch: run_family(data, arch, torch.load(params[arch],
                                                   weights_only=True),
                            mesh_name, par)
           for arch in FAMILY_ARCHS}
    if MESHES[mesh_name][1]:
        w = torch.load(params["mamba2-1.3b"], weights_only=True)
        out["blocks"] = run_blocks(data, w, dist.get_world_size())
    return out
