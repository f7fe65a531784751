"""Every input of a (arch x shape x mesh) cell: global shape, dtype and
per-rank placement, on the meta device.

Counterpart of the reference's ``launch/specs.py``.  ``GEO``, ``ServePlan``
and :func:`serve_plan` are copies (pure arithmetic over the mesh's
``shape`` and ``axis_names``).  :func:`build_cell` returns what the
reference's ``build_cell`` hands to ``jax.jit`` as arguments and
``in_shardings``, without a function to compile: each input is an
:class:`Input` (shape, dtype, spec), whose spec is a tuple of axis names,
tuples of them or None per dim, as a ``PartitionSpec``.

Serving geometry (DESIGN.md §5): page_tokens=64, frame_pages=16.  A
sequence's frames are striped over the page shards (``model`` when the
batch is data-sharded; every mesh axis for the single-sequence long-context
shape), so ``S`` and ``mpps`` are mesh-dependent.  Serving parameters are
bf16 at the tensor-parallel rules, replicated over ``data``, the expert
tensors at the 2-D expert layout where ``models/moe.py::ep2d_geometry``
applies; training's are the port's fp32 masters at its ``state_specs``
(megatron / auto keep them and the moments at the ZeRO-1 shard, fsdp at
its shard, as the reference), with its error-feedback buffers under
``grad_compress`` (one per leaf and rank, at the model shard).  A serving
Mamba-2 leaf is cut by heads (``launch/sharding.py::HeadCut``), which no
spec says: its
:class:`Input` carries the rank's shape beside the reference's spec, and
so does the rank's ``conv`` decode state; its ``ssm`` state splits its
heads over ``model``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    PoolGeometry,
    ShapeConfig,
    TrainHParams,
)
from repro_torch.launch.sharding import (
    SERVING_BATCH_AXES,
    Spec,
    head_cut,
    serving_param_specs,
    shard_shape,
)

GEO = PoolGeometry(page_tokens=64, frame_pages=16, headroom=1.25)


@dataclasses.dataclass(frozen=True)
class Input:
    """One input of a cell: its global ``shape``, ``dtype`` and ``spec``;
    ``rank_shape`` a rank's shape where the port's cut is not the spec's
    (the Mamba-2 head cut), else None."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec = ()
    rank_shape: Optional[Tuple[int, ...]] = None

    def shard_shape(self, mesh) -> Tuple[int, ...]:
        if self.rank_shape is not None:
            return self.rank_shape
        return shard_shape(self.shape, self.spec, mesh)

    def rank_bytes(self, mesh) -> int:
        """Bytes of one rank's shard."""
        return math.prod(self.shard_shape(mesh)) * self.dtype.itemsize


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp_axes(mesh))


@dataclasses.dataclass
class ServePlan:
    """Mesh-dependent paging geometry for one decode/prefill cell."""

    batch_sharded: bool
    S: int                 # page shards a sequence stripes over (tables dim)
    mpps: int              # max pages per (sequence, shard)
    np_global: int         # total pool pages (all pool shards)
    page_axes: Tuple[str, ...]   # table stripe / combine axes
    pool_axes: Tuple[str, ...]   # physical pool page-dim sharding


def serve_plan(shape: ShapeConfig, mesh) -> ServePlan:
    geo = GEO
    ftok = geo.frame_pages * geo.page_tokens
    model = mesh.shape.get("model", 1)
    dp = _dp_size(mesh)
    pool_axes = tuple(a for a in ("pod", "data", "model")
                      if a in mesh.axis_names)
    n_pool_shards = math.prod(mesh.shape[a] for a in pool_axes)
    batch_sharded = shape.global_batch % dp == 0 and shape.global_batch >= dp
    if batch_sharded:
        page_axes = tuple(a for a in ("model",) if a in mesh.axis_names)
        S = model
        n_cells = dp              # independent (data-shard) sub-pools
        seqs_per_cell = shape.global_batch // dp
    else:
        page_axes = pool_axes
        S = n_pool_shards
        n_cells = 1
        seqs_per_cell = shape.global_batch
    # +1 token for the in-flight decode position.
    frames_per_seq = math.ceil((shape.seq_len + 1) / ftok)
    mpps = math.ceil(frames_per_seq / S) * geo.frame_pages
    # Capacity per (cell, model-stripe): worst-stripe frames per sequence
    # x sequences in the cell x headroom.
    frames_per_stripe = math.ceil(
        math.ceil(frames_per_seq / S) * seqs_per_cell * geo.headroom)
    np_global = frames_per_stripe * geo.frame_pages * S * n_cells
    return ServePlan(batch_sharded, S, mpps, np_global, page_axes,
                     pool_axes)


def _axes(axes: Tuple[str, ...]):
    """A spec entry for ``axes`` (None when empty)."""
    return axes if axes else None


def _batch_inputs(cfg: ModelConfig, B: int, T: int, bs) -> Dict[str, Input]:
    """The batch's tokens and frontend inputs, rows over ``bs``."""
    bf16 = torch.bfloat16
    out = {"batch.tokens": Input((B, T), torch.int32, (bs, None))}
    if cfg.family == "vlm":
        out["batch.patch_embeds"] = Input(
            (B, cfg.frontend_tokens, cfg.d_model), bf16, (bs, None, None))
    if cfg.family == "encdec":
        out["batch.src_embeds"] = Input(
            (B, cfg.encdec.source_len, cfg.d_model), bf16, (bs, None, None))
    return out


def _ctx_inputs(B: int, plan: ServePlan, bs) -> Dict[str, Input]:
    i32, pa = torch.int32, _axes(plan.page_axes)
    return {"ctx.tables": Input((B, plan.S, plan.mpps), i32, (bs, pa, None)),
            "ctx.ntok": Input((B, plan.S, plan.mpps), i32, (bs, pa, None)),
            "ctx.wpage": Input((B, plan.S), i32, (bs, pa)),
            "ctx.wslot": Input((B,), i32, (bs,))}


def _state_inputs(lm, mesh, B: int, bs) -> Dict[str, Input]:
    """Decode state (the reference's ``_state_shardings``): SSM states over
    the batch, and over a ``model`` axis > 1 (the Mamba-2 blocks on a
    rank's heads: ``models/mamba2.py::heads_split``) ``ssm``'s heads over
    ``model`` and
    ``conv`` at the rank's channels (the reference keeps both whole over
    ``model``); encdec's cross K/V over the batch and, where they divide,
    the KV heads over ``model``."""
    cfg = lm.cfg
    src = cfg.encdec.source_len if cfg.encdec else 0
    tp = mesh.shape.get("model", 1)
    out = {}
    for k, (shape, dtype) in lm.init_state_shapes(B, src_len=src).items():
        rank_shape = None
        if k in ("ssm", "conv"):
            spec = (None, bs, *([None] * (len(shape) - 2)))
            cut = head_cut(cfg, "decoder.mamba.conv_b", shape[-1:], mesh, 0)
            if cut is not None and k == "ssm":
                spec = (None, bs, "model", None, None)
            elif cut is not None:
                rank_shape = (*shard_shape(shape[:-1], spec, mesh),
                              *cut.shard_shape)
        else:
            kv = "model" if shape[3] % tp == 0 else None
            spec = (None, bs, None, kv, None)
        out[f"state.{k}"] = Input(tuple(shape), dtype, spec, rank_shape)
    return out


def build_cell(arch: str, shape_name: str, mesh,
               hp: Optional[TrainHParams] = None) -> Dict[str, object]:
    """Every input of one (arch x shape x mesh) cell, on the meta device.

    Returns {"kind": "train" | "prefill" | "decode", "plan": ServePlan or
    None, "hp", "inputs": {name: Input}}.  Names: ``params.<leaf>`` (the
    LM's parameter names), ``opt.step`` / ``opt.mu.<leaf>`` /
    ``opt.nu.<leaf>`` and ``ef.<leaf>`` (train), ``batch.<key>`` (train,
    prefill), ``pools.k`` / ``pools.v``, ``ctx.<field>``, ``last_pos``
    (prefill), ``tokens`` / ``pos`` / ``state.<key>`` (decode)."""
    from repro_torch.models.lm import LM
    from repro_torch.models.moe import ep2d_geometry
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    hp = hp or TrainHParams(remat="block")
    B = shape.global_batch

    if shape.kind == "train":
        from repro_torch.train.grad_compress import padded_size
        from repro_torch.train.layout import Placement, batch_axes
        from repro_torch.train.trainer import batch_spec, state_specs
        lm = LM(cfg, device="meta", master=True)
        params = dict(lm.named_parameters())
        pspec, mspec = state_specs(params, hp, mesh)
        f32 = torch.float32
        inputs: Dict[str, Input] = {}
        for n, p in params.items():
            inputs[f"params.{n}"] = Input(tuple(p.shape), f32, pspec[n])
        inputs["opt.step"] = Input((), torch.int32, ())
        for part in ("mu", "nu"):
            for n, p in params.items():
                inputs[f"opt.{part}.{n}"] = Input(tuple(p.shape), f32,
                                                  mspec[n])
        if hp.grad_compress:
            batch = batch_axes(hp.parallelism, mesh)
            D = math.prod(mesh.shape[a] for a in batch)
            for n, p in params.items():
                model = Placement(p.shape, pspec[n], mesh, batch, 0)
                inputs[f"ef.{n}"] = Input(
                    (padded_size(math.prod(model.model_shape), D),), f32, ())
        bs = batch_spec(mesh, hp)[0]
        inputs.update(_batch_inputs(cfg, B, shape.seq_len, bs))
        return {"kind": "train", "plan": None, "hp": hp, "inputs": inputs}

    # Serving: bf16 weights at the TP rules, replicated over data; the
    # expert tensors at the 2-D EP layout where it applies.
    lm = LM(cfg, device="meta")
    params = dict(lm.named_parameters())
    specs = serving_param_specs(params, mesh,
                                ep2d_geometry(cfg, mesh) is not None)
    inputs = {}
    for n, p in params.items():
        cut = head_cut(cfg, n, tuple(p.shape), mesh, 0)
        inputs[f"params.{n}"] = Input(
            tuple(p.shape), torch.bfloat16 if p.dtype.is_floating_point
            else p.dtype, specs[n], cut and cut.shard_shape)
    dp = tuple(a for a in mesh.axis_names if a in SERVING_BATCH_AXES)
    bs = _axes(dp)
    plan = serve_plan(shape, mesh)
    pools = lm.pool_shapes(plan.np_global, GEO.page_tokens)
    for name, (s, dtype) in zip(("k", "v"), pools or ()):
        inputs[f"pools.{name}"] = Input(
            tuple(s), dtype, (None, _axes(plan.pool_axes),
                              *([None] * (len(s) - 2))))
    bsd = bs if plan.batch_sharded else None
    inputs.update(_ctx_inputs(B, plan, bsd))
    if shape.kind == "prefill":
        inputs.update(_batch_inputs(cfg, B, shape.seq_len, bs))
        inputs["last_pos"] = Input((B,), torch.int32, (bs,))
    else:
        inputs["tokens"] = Input((B,), torch.int32, (bsd,))
        inputs["pos"] = Input((B,), torch.int32, (bsd,))
        inputs.update(_state_inputs(lm, mesh, B, bsd))
    return {"kind": shape.kind, "plan": plan, "hp": hp, "inputs": inputs}
