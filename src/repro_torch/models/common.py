"""Parameter init helpers (the distributions of the reference's ``models/common.py``).

The reference draws from ``jax.random``; the port draws the same
distributions from an explicit ``torch.Generator``, so the numbers differ
from the reference's for the same seed.  Tests that compare the two
packages load the reference's weights through :mod:`repro_torch.bridge`
instead of re-drawing them.  :func:`unbind_layers` gives training its
per-layer weight trees (through :func:`train_weight`, which also gathers
a weight the trainer holds as a shard), :func:`layer_remat` and
:data:`ckpt` its per-layer activation recomputation, and
:class:`ParallelCtx` the ranks a forward runs over: its data group and,
for tensor and expert parallelism, its ``model`` group with the three
autograd functions the explicit blocks use, and for serving over a mesh
its page group (the ranks a sequence's frames stripe over) and the data
axis of the 2-D expert parallelism (the port's explicit counterpart of the
reference's ``batch_axes()`` / ``tp_mode()`` / ``serving_mode()`` /
``_ambient_mesh()`` globals; :func:`serving_ctx` builds one from a mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop


def empty_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, frozen weight (filled by ``init_`` or
    ``load_state_dict``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(t: torch.Tensor, in_axis: int,
                generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place: truncated-normal fan-in init (LeCun-style).

    Drawn in float32 (as the reference stores it) and cast once into
    ``t``'s dtype.
    """
    shape: Sequence[int] = t.shape
    fan_in = shape[in_axis] if len(shape) else 1
    scale = 1.0 / max(1.0, fan_in) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(scale))
    return t


def embed_init_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 1) · 0.02, drawn in float32."""
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(0.02))
    return t


def train_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w`` in ``dtype`` for a training forward: its whole value, gathered
    over ranks where the trainer keeps only this rank's shard of it and the
    forward needs it whole (the parameter then carries
    ``train_gather(w, dtype)``: FSDP's all-gather, whose backward
    reduce-scatters, or the gather over ``model`` of a leaf used outside
    the explicit blocks, whose backward takes this rank's chunk), else
    cast."""
    gather = getattr(w, "train_gather", None)
    return w.to(dtype) if gather is None else gather(w, dtype)


def unbind_layers(named: Iterable[Tuple[str, torch.Tensor]], dtype,
                  n: int) -> List[Dict[str, object]]:
    """Per-layer weight trees of ``n`` layers from (name, weight [n, ...])
    pairs: ``ln1`` and ``attn.wq`` of layer l land at ``tree["ln1"]`` and
    ``tree["attn"]["wq"]``.  Each weight is cast to ``dtype`` once and
    unbound along its layer axis, so its gradient comes back as one
    stacked tensor; indexing the stacked weight per layer would make
    autograd build a full-size zero gradient for every layer (the
    reference casts its fp32 params at the loss's entry).  A sharded
    weight is gathered here (:func:`train_weight`)."""
    per_layer: List[Dict[str, object]] = [{} for _ in range(n)]
    for name, w in named:
        group, _, leaf = name.rpartition(".")
        for lp, wl in zip(per_layer, train_weight(w, dtype).unbind(0)):
            (lp.setdefault(group, {}) if group else lp)[leaf] = wl
    return per_layer


REMAT = (False, True, "none", "block", "save_collectives")


def layer_remat(remat) -> bool:
    """Whether a training stack recomputes each layer in the backward:
    every value of :data:`REMAT` except False and "none" (the reference's
    stacks other than the dense one wrap each layer in ``jax.checkpoint``
    when ``remat`` is truthy, so "save_collectives" recomputes whole
    layers there)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not one of {REMAT}")
    return remat not in (False, "none")


def ckpt(fn, *args):
    """Per-layer activation recomputation (non-reentrant, no RNG state: the
    layers draw no random numbers).  The recompute runs the whole of
    ``fn`` again, its all-reduces over ``model`` included, as the
    reference's ``jax.checkpoint`` without a policy (early stop would skip
    what follows the last saved tensor, a layer's closing reduce)."""
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)


# ------------------------------------------------------------ parallelism


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient over ``model``
    (in its dtype): the transpose ``shard_map`` gives an input replicated
    over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over ``model`` in the activation's dtype (the reference's
    bf16 psum); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReplicatedOut(torch.autograd.Function):
    """Identity forward; backward divides the gradient by ``tp``: an output
    every model rank computes alike from inputs that entered by
    copy-to-model, whose all-reduce then counts its gradient once (the
    transpose ``shard_map`` gives an output unmapped over ``model``)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.tp, None


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The ranks a forward runs over.

    ``dp_group``: the data-parallel ranks holding the batch's other rows
    (None: this rank's rows are the batch), this rank ``dp_rank`` of
    ``dp_size`` there; ``model_group``, ``tp`` and ``model_rank``: the
    ``model`` axis (None, 1, 0 without one); ``mode``: ``megatron`` runs
    the explicit blocks (Megatron attention, TP SwiGLU, the MoE training
    EP) on this rank's model shards, ``auto`` none (every ``model``-split
    leaf is gathered and each model rank computes the whole layer).  A
    forward without a context is the one-device path.

    Serving over a mesh (:func:`serving_ctx`) adds ``page_group``: the
    ranks a sequence's frames stripe over (the reference's
    ``PageCtx.page_axes``: ``model`` when the batch is split over the data
    axes, every axis otherwise), this rank holding stripe ``page_rank`` of
    ``page_shards`` (frame f on stripe f % page_shards, the
    ``ShardedKVCache`` contract); ``batch_sharded``: whether the batch rows
    are split over ``dp_group``; ``data_group`` / ``data_rank`` /
    ``data_size``: the ``data`` axis, over which the 2-D expert parallelism
    splits the experts, and ``expert_group`` the ranks of one (data, model)
    grid, over which its decode sums."""

    dp_group: object = None
    model_group: object = None
    tp: int = 1
    model_rank: int = 0
    mode: str = "megatron"
    dp_rank: int = 0
    dp_size: int = 1
    page_group: object = None
    page_rank: int = 0
    page_shards: int = 1
    batch_sharded: bool = True
    data_group: object = None
    data_rank: int = 0
    data_size: int = 1
    expert_group: object = None

    @property
    def explicit(self) -> bool:
        """Whether the explicit tensor / expert-parallel blocks run."""
        return self.mode == "megatron" and self.tp > 1

    @property
    def shape(self) -> Dict[str, int]:
        """The serving mesh's ``data`` and ``model`` sizes, as a mesh's
        ``shape`` reads them (``moe.ep2d_geometry``)."""
        return {"data": self.data_size, "model": self.tp}

    @property
    def ranks(self) -> int:
        """Ranks of the serving mesh this context spans (1: one device)."""
        return max(self.tp * self.dp_size, self.page_shards,
                   self.tp * self.data_size)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.model_group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.model_group)

    def replicated_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReplicatedOut.apply(x, self.tp)

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` all-gathered over ``model`` along ``dim`` (model rank j's
        part j-th; no gradient: serving)."""
        return gather_dim(x, dim, self.model_group, self.tp)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch ``x`` (dim 0): its data
        rank's block when the batch is split, else all of them."""
        if not self.batch_sharded or self.dp_size == 1:
            return x
        n = x.shape[0] // self.dp_size
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]


def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``x`` all-gathered over the ``n`` ranks of ``group`` along ``dim``,
    group rank j's part j-th (``group`` None: ``x``)."""
    if group is None or n == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * n, *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def serving_ctx(mesh, rank: int, batch_sharded: bool = True
                ) -> Optional[ParallelCtx]:
    """The :class:`ParallelCtx` of rank ``rank`` serving over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh` of ``pod`` / ``data`` /
    ``model`` axes over the initialised process group; None for a one-rank
    mesh, the one-device path).  The batch is split over the data axes when
    ``batch_sharded`` (the reference's decode_32k; each data rank's rows
    have their pages striped over ``model``), else every rank sees every
    row and the pages stripe over all axes (long_500k).  Every rank must
    call it (the groups are made collectively), in the same order."""
    if mesh.size == 1:
        return None
    coords = mesh.coords(rank)
    names = mesh.axis_names
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    page_axes = (("model",) if "model" in names else ()) if batch_sharded \
        else tuple(a for a in ("pod", "data", "model") if a in names)

    def index(axes):
        i, n = 0, 1
        for a in axes:
            i, n = i * mesh.shape[a] + coords[a], n * mesh.shape[a]
        return i, n

    dp_rank, dp_size = index(dp_axes) if batch_sharded else (0, 1)
    page_rank, page_shards = index(page_axes)
    data_rank, data_size = index(("data",) if "data" in names else ())
    tp = mesh.shape.get("model", 1)
    return ParallelCtx(
        dp_group=mesh.group(dp_axes) if batch_sharded else None,
        model_group=mesh.group(("model",) if "model" in names else ()),
        tp=tp, model_rank=coords.get("model", 0), dp_rank=dp_rank,
        dp_size=dp_size, page_group=mesh.group(page_axes),
        page_rank=page_rank, page_shards=page_shards,
        batch_sharded=batch_sharded,
        data_group=mesh.group(("data",) if "data" in names else ()),
        data_rank=data_rank, data_size=data_size,
        expert_group=mesh.group(tuple(a for a in ("data", "model")
                                      if a in names)))


def on_mesh(par: Optional[ParallelCtx]) -> bool:
    """Whether a serving forward runs over more than one rank."""
    return par is not None and par.ranks > 1


def explicit(par: Optional[ParallelCtx]) -> bool:
    """Whether ``par`` runs the explicit blocks (None: one device)."""
    return par is not None and par.explicit


def merge_parts(par: Optional[ParallelCtx], parts, reduce: bool):
    """A block's output from its partial outputs: each reduced over
    ``model`` when ``reduce`` (the block ran on this rank's shards), then
    summed in order (the MoE block's routed and shared experts, each with
    its own reduce, as the reference's)."""
    out = None
    for t in parts:
        t = par.reduce_from_model(t) if reduce else t
        out = t if out is None else out + t
    return out
