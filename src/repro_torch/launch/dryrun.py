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
    decode state) and their sum; activations are not counted (null);
  * ``fits``: whether that sum fits one card: the card's
    ``torch.cuda.get_device_properties(0).total_memory`` when one is
    visible, else 80 GB (NVIDIA H100 SXM5 datasheet);
  * ``model_flops``: 6 (train) or 2 x active parameters x tokens;
  * ``hbm_bytes_per_chip``: the port's own copy of the reference's
    analytic byte model (``benchmarks/analytic.py``; :func:`memory_bytes`);
  * ``collective_bytes_per_chip``: the bytes a rank sends per step,
    counted from the port's layout (:func:`collective_bytes`; a ring moves
    (n - 1) / n of a gathered or scattered tensor and 2 (n - 1) / n of an
    all-reduced one over n ranks); null where the port does not count
    them (the training of hybrid, ssm, encdec and vlm, and
    ``grad_compress``'s int8 ring);
  * the three roofline terms at the H100 SXM5 datasheet figures:
    989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s per direction of
    NVLink (fourth generation), and the largest of them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Callable, Dict, Optional

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
    """Bytes a rank sends, by collective kind (ring algorithms)."""

    def __init__(self):
        self.kinds = {"all_reduce": 0.0, "all_gather": 0.0,
                      "reduce_scatter": 0.0}

    def __call__(self, kind: str, nbytes: float, n: int, times=1) -> None:
        """``times`` collectives of ``kind`` over ``n`` ranks, each of a
        tensor of ``nbytes`` (the gathered output, the scattered input, the
        all-reduced tensor)."""
        if n > 1:
            self.kinds[kind] += times * nbytes * (n - 1) / n * (
                2 if kind == "all_reduce" else 1)

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


def _train_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       hp: TrainHParams, add: Callable) -> None:
    """The training step's collectives (``train/trainer.py`` and the
    explicit blocks of ``models/{transformer,moe}.py``): per microbatch
    the blocks' all-reduces over ``model`` (forward reduces, the
    copy-to-model backward of the block input and of the replicated
    weights inside a block; "block" remat reduces again in its recompute)
    and the gathers of ``model``-split leaves outside the blocks; per step
    the gradients' reduction over the batch axes (ZeRO-1: reduce-scatter,
    then the updated masters' all-gather; fsdp: the gathers in
    ``cfg.dtype`` and f32 reduce-scatters of every microbatch), the grad
    norm's, the step's means of its loss, nll and aux over the batch
    ranks, and ``Trainer.run``'s preemption flag."""
    from repro_torch.models.common import ParallelCtx
    from repro_torch.models.lm import LM
    from repro_torch.models.transformer import kv_sharded, tp_geometry
    from repro_torch.train.layout import Placement, batch_axes
    from repro_torch.train.trainer import state_specs
    batch = batch_axes(hp.parallelism, mesh)
    D = math.prod(mesh.shape[a] for a in batch)
    tp = math.prod(mesh.shape[a] for a in mesh.axis_names if a not in batch)
    micro = hp.microbatch if hp.microbatch and hp.microbatch > 1 else 1
    rows = shape.global_batch // D * shape.seq_len     # over all micros
    E = DTYPE_BYTES[cfg.dtype]
    act = rows * cfg.d_model * E
    explicit = hp.parallelism == "megatron" and tp > 1
    fwd = 2 if hp.remat in (True, "block") else 1      # recompute reduces
    if explicit:
        for lcfg, n in _stacks(cfg):
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
                n * micro)                               # the router
            add("all_reduce", mo.n_experts * F32, D, n * micro * fwd)
    elif cfg.moe is not None:
        n = cfg.n_layers - cfg.moe.first_dense
        add("all_reduce", cfg.moe.n_experts * F32, D, n * micro * fwd)
    lm = LM(cfg, device="meta", master=True)
    params = dict(lm.named_parameters())
    pspec, mspec = state_specs(params, hp, mesh)
    par = ParallelCtx(tp=tp, mode="auto" if hp.parallelism == "auto"
                      else "megatron")
    for name, p in params.items():
        full = math.prod(p.shape)
        pplace = Placement(p.shape, pspec[name], mesh, batch, 0)
        mplace = Placement(p.shape, mspec[name], mesh, batch, 0)
        shard = math.prod(pplace.model_shape)
        if hp.parallelism == "fsdp":
            if pplace.sharded:
                add("all_gather", full * E, pplace.n, micro)
                add("reduce_scatter", full * F32, pplace.n, micro)
            else:
                add("all_reduce", full * F32, D)
            continue
        if pplace.model is not None and not lm.model_local(name, par):
            add("all_gather", full * E, pplace.model.n, micro)
        if mplace.data is not None:
            add("reduce_scatter", shard * F32, mplace.data.n)
            add("all_gather", shard * F32, mplace.data.n)
        else:
            add("all_reduce", shard * F32, D)
    add("all_reduce", F32, mesh.size)                   # the grad norm
    add("all_reduce", 3 * F32, D)             # the loss, nll and aux means
    add("all_reduce", 8, mesh.size)   # Trainer.run's preemption flag (int64)


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, cell
                     ) -> Optional[Dict[str, float]]:
    """Bytes a rank sends in one step of ``cell`` (:func:`~repro_torch.
    launch.specs.build_cell`'s; only its ``kind``, ``hp`` and ``plan`` are
    read), by kind, or None where the port does not count them (module
    docstring).  Activations and weights move in ``cfg.dtype``, gradients,
    moments and the attention combine's partials in f32."""
    add = _Sent()
    if cell["kind"] == "train":
        if cfg.family not in ("dense", "moe") or cell["hp"].grad_compress:
            return None
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


def per_device_bytes(cell, mesh) -> Dict[str, object]:
    """One rank's bytes of each input part of ``cell`` and their sum;
    training also holds a gradient of every parameter at its shard (f32)."""
    parts: Dict[str, int] = {}
    for name, inp in cell["inputs"].items():
        part = PARTS.get(name, name.split(".")[0])
        parts[part] = parts.get(part, 0) + inp.rank_bytes(mesh)
    if cell["kind"] == "train":
        parts["grads"] = parts["params"]
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
             "collective_s": None if coll is None
             else coll["total"] / LINK_BW}
    known = {k: v for k, v in terms.items() if v is not None}
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
        "bottleneck": max(known, key=known.get),
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
