"""Parameter init helpers (the distributions of the reference's ``models/common.py``).

The reference draws from ``jax.random``; the port draws the same
distributions from an explicit ``torch.Generator``, so the numbers differ
from the reference's for the same seed.  Tests that compare the two
packages load the reference's weights through :mod:`repro_torch.bridge`
instead of re-drawing them.  :func:`unbind_layers` gives training its
per-layer weight trees (through :func:`train_weight`, which also gathers
a weight the trainer holds as a shard), :func:`layer_remat` and
:data:`ckpt` its per-layer activation recomputation, and
:class:`ParallelCtx` the ranks a training forward runs over: its data
group and, for tensor and expert parallelism, its ``model`` group with the
three autograd functions the explicit blocks use (the port's explicit
counterpart of the reference's ``batch_axes()`` / ``tp_mode()`` /
``_ambient_mesh()`` globals).
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
    """The ranks a training forward runs over.

    ``dp_group``: the data-parallel ranks holding the batch's other rows
    (None: this rank's rows are the batch); ``model_group``, ``tp`` and
    ``model_rank``: the ``model`` axis (None, 1, 0 without one); ``mode``:
    ``megatron`` runs the explicit blocks (Megatron attention, TP SwiGLU,
    the MoE training EP) on this rank's model shards, ``auto`` none (every
    ``model``-split leaf is gathered and each model rank computes the
    whole layer).  A forward without a context is the one-device path."""

    dp_group: object = None
    model_group: object = None
    tp: int = 1
    model_rank: int = 0
    mode: str = "megatron"

    @property
    def explicit(self) -> bool:
        """Whether the explicit tensor / expert-parallel blocks run."""
        return self.mode == "megatron" and self.tp > 1

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.model_group)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.model_group)

    def replicated_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReplicatedOut.apply(x, self.tp)


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
