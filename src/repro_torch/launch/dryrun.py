"""Dry run: every (arch x shape x mesh) cell's per-rank memory, FLOPs, HBM
bytes and collective bytes, from the port's own layout.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
        --shape decode_32k --mesh pod          # 16 x 16 (256 ranks)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell with XLA against TPU v5e constants.  The port compiles
nothing and forces no device count: :func:`~repro_torch.launch.specs.
build_cell` places every input on the meta device, and each cell prints
one JSON line (also appended to ``--out``) with

  * ``per_device_bytes``: one rank's bytes of every input part (params,
    optimizer state, error feedback, gradients, batch, pools, page tables,
    decode state) and their sum; activations are not counted (null: the
    reference reads them from XLA's ``memory_analysis()``, which has no
    PyTorch counterpart);
  * ``fits``: whether that sum fits one card: the card's
    ``torch.cuda.get_device_properties(0).total_memory`` when one is
    visible, else 80 GB (NVIDIA H100 SXM5 datasheet);
  * ``model_flops``: 6 (train) or 2 x active parameters x tokens;
  * ``hbm_bytes_per_chip``: the port's own copy of the reference's
    analytic byte model (``benchmarks/analytic.py``; :func:`memory_bytes`);
  * ``collective_bytes_per_chip``: the bytes a rank sends per step,
    counted from the port's layout (:func:`collective_bytes`; a ring moves
    (n - 1) / n of a gathered or scattered tensor and 2 (n - 1) / n of an
    all-reduced one over n ranks; ``grad_compress``'s ring hops as
    ``p2p``, each its whole int8 chunk and f32 scales), for every cell;
  * the three roofline terms at the H100 SXM5 datasheet figures:
    989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s per direction of
    NVLink (fourth generation), and the largest of them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Callable, Dict

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainHParams,
)
from repro_torch.launch.mesh import Mesh, make_production_mesh

# NVIDIA H100 SXM5 datasheet figures, per card.
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink bytes/s per direction
HBM_BYTES = 80e9             # HBM3 capacity
DATASHEET = "NVIDIA H100 SXM5 datasheet"

BF16, F32 = 2, 4
DTYPE_BYTES = {"bfloat16": BF16, "float16": 2, "float32": F32}


# ------------------------------------------------------------ HBM traffic


def _mesh_factors(mesh) -> Dict[str, int]:
    tp = mesh.shape.get("model", 1)
    dp = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    return {"tp": tp, "dp": dp, "chips": tp * dp}


def kv_bytes_per_token_layer(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0                              # attention-free: no KV
    if cfg.mla is not None:
        m = cfg.mla
        return (m.kv_lora_rank + m.qk_rope_head_dim
                + m.kv_lora_rank) * BF16      # k payload + v payload
    return 2 * cfg.n_kv_heads * cfg.resolved_head_dim * BF16


def kv_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.period
    if cfg.family == "encdec":
        return cfg.encdec.dec_layers
    return cfg.n_layers


def memory_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh
                 ) -> Dict[str, float]:
    """Bytes of HBM traffic per chip per step: a copy of the reference's
    analytic model (``benchmarks/analytic.py``), whose every term is a
    documented over- or under-approximation there."""
    f = _mesh_factors(mesh)
    tp, dp, chips = f["tp"], f["dp"], f["chips"]
    P = cfg.param_count()
    d = cfg.d_model
    L = cfg.n_layers

    if shape.kind == "train":
        toks_local = shape.global_batch * shape.seq_len / dp
        w = 3 * BF16 * P / tp
        g = 2 * F32 * P / tp
        opt = 6 * F32 * P / chips
        c_act = 16
        if cfg.moe:
            c_act += 4 * cfg.moe.top_k
        act = L * toks_local * d * BF16 * c_act
        emb = 2 * toks_local * cfg.vocab_size / tp * BF16
        total = w + g + opt + act + emb
        return {"weights": w, "grads": g, "opt": opt, "act": act,
                "emb": emb, "total": total}

    if shape.kind == "prefill":
        toks_local = shape.global_batch * shape.seq_len / dp
        w = BF16 * P / tp
        c_act = 8 + (2 * cfg.moe.top_k if cfg.moe else 0)
        act = L * toks_local * d * BF16 * c_act
        kvw = (shape.global_batch * shape.seq_len
               * kv_bytes_per_token_layer(cfg) * kv_layers(cfg) / chips)
        emb = toks_local * cfg.vocab_size / tp * BF16 / shape.seq_len
        total = w + act + kvw + emb
        return {"weights": w, "act": act, "kv_write": kvw, "emb": emb,
                "total": total}

    if cfg.moe:
        dense_p = cfg.active_param_count() - (
            (cfg.n_layers - cfg.moe.first_dense)
            * 3 * d * cfg.moe.d_expert * cfg.moe.top_k)
        expert_p = P - dense_p
        B_tok = max(1.0, shape.global_batch / dp)
        frac = min(1.0, B_tok * cfg.moe.top_k / cfg.moe.n_experts)
        w = BF16 * (dense_p + expert_p * frac) / tp
    else:
        w = BF16 * P / tp
    kv = (shape.global_batch * (shape.seq_len + 1)
          * kv_bytes_per_token_layer(cfg) * kv_layers(cfg) / chips)
    if cfg.family == "encdec":
        kv += (shape.global_batch * cfg.encdec.source_len
               * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * BF16
               * cfg.encdec.dec_layers / chips)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        state = cfg.n_layers * shape.global_batch * nh * s.head_dim \
            * s.d_state * F32 * 2 / dp
        kv += state
    act = L * max(1.0, shape.global_batch / dp) * d * BF16 * 12
    emb = max(1.0, shape.global_batch / dp) * cfg.vocab_size / tp * BF16 \
        + cfg.vocab_size * d * BF16 / tp
    total = w + kv + act + emb
    return {"weights": w, "kv": kv, "act": act, "emb": emb, "total": total}


# ------------------------------------------------------------ collectives


class _Sent:
    """Bytes a rank sends, by collective kind: ring algorithms for the
    collectives; a point-to-point send (``p2p``) and a broadcast count
    their whole tensor (a broadcast's root's)."""

    FACTOR = {"all_reduce": lambda n: 2 * (n - 1) / n,
              "all_gather": lambda n: (n - 1) / n,
              "reduce_scatter": lambda n: (n - 1) / n,
              "p2p": lambda n: 1, "broadcast": lambda n: 1}

    def __init__(self):
        self.kinds = {"all_reduce": 0.0, "all_gather": 0.0,
                      "reduce_scatter": 0.0}

    def __call__(self, kind: str, nbytes: float, n: int, times=1) -> None:
        """``times`` collectives of ``kind`` over ``n`` ranks, each of a
        tensor of ``nbytes`` (the gathered output, the scattered input, the
        all-reduced tensor, the sent or broadcast tensor)."""
        if n > 1:
            self.kinds[kind] = self.kinds.get(kind, 0.0) \
                + times * nbytes * self.FACTOR[kind](n)

    def result(self) -> Dict[str, float]:
        return dict(self.kinds, total=sum(self.kinds.values()))


def _stacks(cfg: ModelConfig):
    """(layer config, layers) of the decoder: a MoE model's dense-FFN
    prefix, then the rest."""
    import dataclasses
    fd = cfg.moe.first_dense if cfg.moe is not None else 0
    out = [(dataclasses.replace(cfg, moe=None), fd)] if fd else []
    return out + [(cfg, cfg.n_layers - fd)]


def _attention_stacks(cfg: ModelConfig):
    """(layer config, layers) of the paged attention blocks a serving step
    runs: the decoder's (:func:`_stacks`), the hybrid's shared-block
    invocations, encdec's decoder layers, none for ssm."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(cfg, cfg.n_layers // cfg.hybrid.period)]
    if cfg.family == "encdec":
        return [(cfg, cfg.encdec.dec_layers)]
    return _stacks(cfg)


def _serving_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, plan,
                         add: Callable) -> None:
    """The serving paths' collectives (``models/{lm,transformer,mla,moe,
    mamba2,hybrid,encdec,page_ops}.py`` over a serving ``ParallelCtx``)."""
    from repro_torch.models.moe import ep2d_geometry
    from repro_torch.models.transformer import kv_sharded, tp_geometry
    tp = mesh.shape.get("model", 1)
    data = mesh.shape.get("data", 1)
    dp = math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))
    B = shape.global_batch
    B_loc = B // dp if plan.batch_sharded else B
    decode = shape.kind == "decode"
    tokens = B_loc * (1 if decode else shape.seq_len)
    # vlm's prefill runs the patch embeddings in front of the tokens.
    rows = tokens + (B_loc * cfg.frontend_tokens
                     if cfg.family == "vlm" and not decode else 0)
    d, V, H = cfg.d_model, cfg.vocab_size, cfg.n_heads
    E = DTYPE_BYTES[cfg.dtype]
    act = rows * d * E
    if tp > 1 and V % tp == 0:
        add("all_reduce", tokens * d * E, tp)            # embedding
        add("all_gather", B_loc * V * E, tp)          # logits
    if cfg.family in ("ssm", "hybrid") and tp > 1:
        # Each Mamba-2 layer: the gated norm's f32 sum of squares, w_out.
        add("all_reduce", rows * F32, tp, cfg.n_layers)
        add("all_reduce", act, tp, cfg.n_layers)
    geo = tp_geometry(cfg, tp) if tp > 1 and H else None
    if cfg.family == "encdec" and geo is not None:
        if not decode:        # the encoder: attention and SwiGLU reduces
            src = B_loc * cfg.encdec.source_len * d * E
            add("all_reduce", src, tp, cfg.encdec.enc_layers * (
                2 if cfg.d_ff % tp == 0 else 1))
        add("all_reduce", act, tp, cfg.encdec.dec_layers)   # cross-attn
    for lcfg, n in _attention_stacks(cfg):
        if lcfg.mla is not None:
            m = lcfg.mla
            split = tp > 1 and H % tp == 0
            dh_v = m.kv_lora_rank
            if split and decode:
                add("all_gather", rows * H * (m.kv_lora_rank
                                              + m.qk_rope_head_dim) * E,
                    tp, n)
            if split:
                add("all_reduce", act, tp, n)
        else:
            dh, Hkv = lcfg.resolved_head_dim, lcfg.n_kv_heads
            dh_v = dh
            geo = tp_geometry(lcfg, tp) if tp > 1 else None
            if geo is not None:
                if decode:
                    add("all_gather", rows * H * dh * E, tp, n)
                if kv_sharded(lcfg, geo):
                    add("all_gather", rows * Hkv * dh * E, tp, 2 * n)
                add("all_reduce", act, tp, n)
        if decode and plan.S > 1:                        # the combine
            add("all_reduce", rows * H * F32, plan.S, n)
            add("all_reduce", rows * H * (dh_v + 1) * F32, plan.S, n)
        mo = lcfg.moe
        if mo is None:
            if tp > 1 and lcfg.d_ff % tp == 0:
                add("all_reduce", act, tp, n)
            continue
        geo2 = ep2d_geometry(lcfg, mesh)
        if geo2 is not None and decode:
            if plan.batch_sharded:
                add("all_gather", B * d * E, dp, n)
            add("all_reduce", (B if plan.batch_sharded else B_loc) * d * E,
                data * tp, n)
        elif geo2 is not None:
            add("all_gather", 3 * mo.n_experts * d * geo2[1] * E, data,
                n)
            add("all_reduce", act, tp, n)
        elif tp > 1:
            add("all_reduce", act, tp, n * (2 if mo.n_shared else 1))
            if plan.batch_sharded:
                add("all_reduce", mo.n_experts * F32, dp, n)


def _train_stacks(cfg: ModelConfig, shape: ShapeConfig, D: int, remat):
    """(layer config, layers, rows, recomputed) of each stack of explicit
    blocks a training step runs (``LM.loss``): rows over all microbatches
    of this batch rank; ``recomputed`` whether a layer's backward runs its
    forward again, its reduces included.  The decoder of dense, moe and
    vlm (:func:`_stacks`; vlm's rows also carry the patch embeddings),
    recomputed under "block"; the hybrid's shared block once per
    invocation, never recomputed; encdec's encoder over the source frames
    and its decoder, each layer recomputed under any remat; none for
    ssm."""
    from repro_torch.models.common import layer_remat
    B = shape.global_batch // D
    rows = B * shape.seq_len
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(cfg, cfg.n_layers // cfg.hybrid.period, rows, False)]
    if cfg.family == "encdec":
        on = layer_remat(remat)
        return [(cfg, cfg.encdec.enc_layers, B * cfg.encdec.source_len, on),
                (cfg, cfg.encdec.dec_layers, rows, on)]
    if cfg.family == "vlm":
        rows += B * cfg.frontend_tokens
    return [(lcfg, n, rows, remat in (True, "block"))
            for lcfg, n in _stacks(cfg)]


def _block_collectives(stacks, E: int, tp: int, D: int, micro: int,
                       add: Callable) -> None:
    """The explicit blocks' all-reduces over ``model`` (and the MoE loads'
    over the batch ranks) of :func:`_train_stacks`' stacks: per layer the
    GQA attention's and the SwiGLU's (or the MoE block's) forward reduce,
    again in a recompute, and the copy-to-model backward of the block
    input; per layer and microbatch the copy-to-model backward of each
    weight replicated into a block (k / v projections that the model axis
    does not split, qwen3's q_norm / k_norm, the router)."""
    from repro_torch.models.transformer import kv_sharded, tp_geometry
    for lcfg, n, rows, recomputed in stacks:
        act = rows * lcfg.d_model * E
        fwd = 2 if recomputed else 1
        if lcfg.mla is None:
            geo = tp_geometry(lcfg, tp)
            if geo is not None:
                add("all_reduce", act, tp, n * (fwd + 1))
                copies = []
                if not kv_sharded(lcfg, geo):
                    w = lcfg.d_model * lcfg.n_kv_heads \
                        * lcfg.resolved_head_dim
                    copies += [w, w]
                    if lcfg.qkv_bias:
                        b = lcfg.n_kv_heads * lcfg.resolved_head_dim
                        copies += [b, b]
                if lcfg.qk_norm:
                    copies += [lcfg.resolved_head_dim] * 2
                for c in copies:
                    add("all_reduce", c * E, tp, n * micro)
        mo = lcfg.moe
        if mo is None:
            if lcfg.d_ff % tp == 0:
                add("all_reduce", act, tp, n * (fwd + 1))
            continue
        parts = 2 if mo.n_shared else 1
        add("all_reduce", act, tp, n * (fwd * parts + 1))
        add("all_reduce", lcfg.d_model * mo.n_experts * E, tp,
            n * micro)                                   # the router
        add("all_reduce", mo.n_experts * F32, D, n * micro * fwd)


def _train_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       hp: TrainHParams, add: Callable) -> None:
    """The training step's collectives (``train/trainer.py`` and the
    explicit blocks of ``models/{transformer,moe,hybrid,encdec}.py``): per
    microbatch the blocks' all-reduces (:func:`_block_collectives`) and the
    gathers of ``model``-split leaves outside the blocks (MLA, Mamba-2,
    the embeddings, encdec's cross-attention; every such leaf under auto);
    per step, per leaf, the gradient's reduction over the batch axes:
    ZeRO-1's reduce-scatter of the f32 model-shard gradient and the
    all-gather of the next step's cast copy in ``cfg.dtype`` (an
    all-reduce where the leaf is not split over data); fsdp's gathers in
    ``cfg.dtype`` and f32 reduce-scatters of every microbatch; under
    ``grad_compress`` the int8 ring instead of the f32 reduction (2 (D -
    1) hops over the data group, each sending an int8 chunk of the leaf's
    model-shard gradient padded to ``grad_compress.padded_size`` and its
    f32 block scales, then the broadcast that makes a leaf's shard agree
    across its batch replicas); then the grad norm's all-reduce, the
    step's means of its loss, nll and aux over the batch ranks, and
    ``Trainer.run``'s preemption flag."""
    from repro_torch.models.common import ParallelCtx
    from repro_torch.models.lm import LM
    from repro_torch.train.grad_compress import BLOCK, padded_size
    from repro_torch.train.layout import Placement, batch_axes
    from repro_torch.train.trainer import state_specs
    batch = batch_axes(hp.parallelism, mesh)
    D = math.prod(mesh.shape[a] for a in batch)
    tp = math.prod(mesh.shape[a] for a in mesh.axis_names if a not in batch)
    micro = hp.microbatch if hp.microbatch and hp.microbatch > 1 else 1
    E = DTYPE_BYTES[cfg.dtype]
    if hp.parallelism == "megatron" and tp > 1:
        _block_collectives(_train_stacks(cfg, shape, D, hp.remat), E, tp,
                           D, micro, add)
    elif cfg.moe is not None:
        n = cfg.n_layers - cfg.moe.first_dense
        fwd = 2 if hp.remat in (True, "block") else 1
        add("all_reduce", cfg.moe.n_experts * F32, D, n * micro * fwd)
    lm = LM(cfg, device="meta", master=True)
    params = dict(lm.named_parameters())
    pspec, _ = state_specs(params, hp, mesh)
    par = ParallelCtx(tp=tp, mode="auto" if hp.parallelism == "auto"
                      else "megatron")
    fsdp = hp.parallelism == "fsdp"
    for name, p in params.items():
        full = math.prod(p.shape)
        place = Placement(p.shape, pspec[name], mesh, batch, 0)
        shard = math.prod(place.model_shape)            # the model shard
        held = shard // (place.data.n if place.data else 1)
        reps = math.prod(mesh.shape[a] for a in place.replica_axes)
        if fsdp and place.sharded:
            add("all_gather", full * E, place.n, micro)
            if not hp.grad_compress:    # GatherFn's backward: place.reduce
                add("reduce_scatter", full * F32, place.n, micro)
                add("all_reduce", held * F32, reps, micro)
                continue
        elif place.model is not None and not lm.model_local(name, par):
            add("all_gather", full * E, place.model.n, micro)
        if not fsdp and place.data is not None:
            add("all_gather", shard * E, place.data.n)  # the cast copy
        if hp.grad_compress:
            chunk = padded_size(shard, D) // D
            add("p2p", chunk + chunk // BLOCK * F32, D, 2 * (D - 1))
            add("broadcast", held * F32, reps)          # place.agree
        else:                                           # place.reduce
            if place.data is not None:
                add("reduce_scatter", shard * F32, place.data.n)
            add("all_reduce", held * F32, reps)
    add("all_reduce", F32, mesh.size)                   # the grad norm
    add("all_reduce", 3 * F32, D)             # the loss, nll and aux means
    add("all_reduce", 8, mesh.size)   # Trainer.run's preemption flag (int64)


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, cell
                     ) -> Dict[str, float]:
    """Bytes a rank sends in one step of ``cell`` (:func:`~repro_torch.
    launch.specs.build_cell`'s; only its ``kind``, ``hp`` and ``plan`` are
    read), by kind.  Activations and weights move in ``cfg.dtype``,
    gradients, moments and the attention combine's partials in f32, the
    compressed gradient as int8 chunks with f32 block scales."""
    add = _Sent()
    if cell["kind"] == "train":
        _train_collectives(cfg, shape, mesh, cell["hp"], add)
    else:
        _serving_collectives(cfg, shape, mesh, cell["plan"], add)
    return add.result()


# ------------------------------------------------------------ cells


def capacity() -> tuple:
    """(bytes of one card's memory, where the number comes from)."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return (props.total_memory,
                f"torch.cuda.get_device_properties(0).total_memory "
                f"({props.name})")
    return HBM_BYTES, f"{DATASHEET}: 80 GB HBM3"


PARTS = {"tokens": "batch", "pos": "batch", "last_pos": "batch"}


def _grad_bytes(cell, mesh) -> int:
    """One rank's f32 gradient bytes in a training step: at the fsdp shard
    (each microbatch's gradient is reduce-scattered there); under megatron
    and auto at the model shard, where the step sums the microbatches
    before reducing them over the data ranks to the ZeRO-1 shard."""
    from repro_torch.train.layout import Placement, batch_axes
    hp = cell["hp"]
    batch = batch_axes(hp.parallelism, mesh)
    total = 0
    for name, inp in cell["inputs"].items():
        if not name.startswith("params."):
            continue
        shape = inp.shard_shape(mesh) if hp.parallelism == "fsdp" \
            else Placement(inp.shape, inp.spec, mesh, batch, 0).model_shape
        total += F32 * math.prod(shape)
    return total


def per_device_bytes(cell, mesh) -> Dict[str, object]:
    """One rank's bytes of each input part of ``cell`` and their sum;
    training also holds a gradient of every parameter
    (:func:`_grad_bytes`)."""
    parts: Dict[str, int] = {}
    for name, inp in cell["inputs"].items():
        part = PARTS.get(name, name.split(".")[0])
        parts[part] = parts.get(part, 0) + inp.rank_bytes(mesh)
    if cell["kind"] == "train":
        parts["grads"] = _grad_bytes(cell, mesh)
    return {"parts": parts, "total": sum(parts.values()),
            "activations": None}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             parallelism: str = "megatron", remat: str = "block",
             tp: int = 0, microbatch: int = 0,
             grad_compress: bool = False) -> Dict[str, object]:
    """One cell's JSON record (module docstring)."""
    from repro_torch.launch.specs import build_cell
    hp = TrainHParams(remat=remat, parallelism=parallelism,
                      microbatch=microbatch, grad_compress=grad_compress)
    if tp:
        # The reference's TP re-factoring: the same rank count, a model
        # axis of ``tp``, the rest data parallel.
        per_pod = 256 // tp
        mesh = Mesh((2, per_pod, tp) if multi_pod else (per_pod, tp),
                    ("pod", "data", "model") if multi_pod
                    else ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell = build_cell(arch, shape_name, mesh, hp)
    mem = per_device_bytes(cell, mesh)
    cap, source = capacity()
    n = mesh.size
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) \
        * cfg.active_param_count() * tokens
    hbm = memory_bytes(cfg, shape, mesh)["total"]
    coll = collective_bytes(cfg, shape, mesh, cell)
    terms = {"compute_s": model_flops / (n * PEAK_FLOPS),
             "memory_s": hbm / HBM_BW,
             "collective_s": coll["total"] / LINK_BW}
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape.values())),
        "parallelism": parallelism, "remat": remat,
        "tp": tp or mesh.shape.get("model", 0), "microbatch": microbatch,
        "grad_compress": grad_compress, "chips": n,
        "per_device_bytes": mem, "capacity_bytes": cap,
        "capacity_source": source, "fits": mem["total"] <= cap,
        "model_flops": model_flops, "hbm_bytes_per_chip": hbm,
        "collective_bytes_per_chip": coll, **terms,
        "bottleneck": max(terms, key=terms.get),
        "roofline_source": f"{DATASHEET}: {PEAK_FLOPS / 1e12:g} TFLOP/s "
                           f"dense bf16, {HBM_BW / 1e12:g} TB/s HBM3, "
                           f"{LINK_BW / 1e9:g} GB/s NVLink per direction",
    }
    if cell["plan"] is not None:
        p = cell["plan"]
        rec["plan"] = {"batch_sharded": p.batch_sharded, "S": p.S,
                       "mpps": p.mpps, "np_global": p.np_global}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--parallelism", choices=["megatron", "auto", "fsdp"],
                    default="megatron")
    ap.add_argument("--remat", choices=["none", "block", "save_collectives"],
                    default="save_collectives")
    ap.add_argument("--tp", type=int, default=0,
                    help="re-factor the 256-rank pod as (256/tp) x tp")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = (f"{arch} x {shape} x "
                         f"{'2x16x16' if mp else '16x16'}"
                         f"{' x fsdp' if args.parallelism == 'fsdp' else ''}")
                print(f"=== {label}", flush=True)
                try:
                    rec = run_cell(arch, shape, mp,
                                   parallelism=args.parallelism,
                                   remat=args.remat, tp=args.tp,
                                   microbatch=args.microbatch,
                                   grad_compress=args.grad_compress)
                except Exception as e:  # noqa: BLE001 - report, continue
                    failures.append((label, repr(e)))
                    print(f"FAILED {label}: {e!r}", flush=True)
                    continue
                line = json.dumps(rec)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for lab, err in failures:
            print(" ", lab, err[:200])
        return 1
    print("\nALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
