"""Where each training leaf lives across ranks, and the collectives that
move it.

A :class:`Placement` is one leaf's spec (:mod:`repro_torch.launch.sharding`)
applied to this rank under a parallelism's batch axes.  It holds up to two
splits of the full leaf: the ``model`` split (tensor / expert parallelism,
from ``param_specs``; none under fsdp, where ``model`` carries batch rows),
and the split over the batch axes (ZeRO-1's ``zero1_extend`` or fsdp's
spec), which cuts the model shard further.  A compound entry
``("model", "data")`` splits one dim model-major, as a ``PartitionSpec``
does: the data split is then taken inside the model shard.  The batch axes
of size > 1 over which the leaf is not split are its ``replica_axes``.

The collectives are sums; callers divide by the number of batch ranks.
Group rank j holds shard j (row-major over the group's axes), which is the
order ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` use.

Three rules keep a ``model`` axis > 1 equal to the reference's
``shard_map`` blocks (``repro_torch.models.common.ParallelCtx`` holds the
autograd functions):

1. Every leaf the reference splits over ``model`` is held split: the
   trainer's parameter is this rank's model shard.  Nothing is kept whole
   for simplicity.
2. Inside an explicit block (Megatron attention, TP SwiGLU, the MoE
   training EP) a leaf replicated over ``model`` goes through
   copy-to-model (identity forward, all-reduce over ``model`` backward),
   exactly where ``shard_map`` transposes a replicated input into a
   ``model`` sum: the block input x, the router, qwen3's ``q_norm`` /
   ``k_norm``, and the k / v projections when the kv heads do not divide
   the model axis.
3. A ``model``-split leaf used outside an explicit block (MLA, Mamba-2,
   the embeddings, encdec's cross-attention, everything under ``auto``) is
   gathered over ``model`` (:class:`GatherFn`).  Outside the blocks every
   model rank computes the same values, so the whole leaf's gradient is
   the same on every model rank and the shard's gradient is its chunk:
   where GSPMD reshards the gradient, the gather's backward takes this
   rank's chunk (a reduce-scatter would sum the model ranks' equal copies).

:class:`GatherFn` is also FSDP's weight gather: forward all-gathers the
shards in the compute dtype, backward reduce-scatters the f32 gradient
(there every rank holds other batch rows, so the gradients are partial).
:class:`GatherFn` also carries ZeRO-1's masters: a master held at its
data shard enters the forward as the step's cast copy, already gathered
over data (its ``copy``), and its gradient is kept at the model shard for
the step's reduce-scatter.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Batch (data-parallel) axes of each parallelism: under fsdp every mesh axis
# carries batch rows (the reference's ``configure_parallelism``).
BATCH_AXES = {"megatron": ("pod", "data"), "auto": ("pod", "data"),
              "fsdp": ("pod", "data", "model")}


def batch_axes(parallelism: str, mesh) -> Tuple[str, ...]:
    """The mesh's batch axes under ``parallelism``, in mesh order."""
    if parallelism not in BATCH_AXES:
        raise ValueError(f"unknown parallelism {parallelism!r}")
    return tuple(a for a in mesh.axis_names if a in BATCH_AXES[parallelism])


def _contiguous_dim0(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.movedim(dim, 0).contiguous()


class _Split:
    """One dim of a leaf cut over ``axes``: this rank holds part ``index``
    of ``n``."""

    def __init__(self, dim: int, axes: Tuple[str, ...], mesh, coords):
        self.dim, self.axes, self.mesh = dim, axes, mesh
        self.n, self.index = 1, 0
        for a in axes:
            self.n *= mesh.shape[a]
            self.index = self.index * mesh.shape[a] + coords[a]

    def take(self, t: torch.Tensor) -> torch.Tensor:
        size = t.shape[self.dim] // self.n
        return t.narrow(self.dim, self.index * size, size)

    @property
    def group(self):
        return self.mesh.group(self.axes)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        moved = _contiguous_dim0(shard, self.dim)
        out = moved.new_empty((moved.shape[0] * self.n, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=self.group)
        out = out.movedim(0, self.dim)
        return out if self.dim == 0 else out.contiguous()

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        moved = _contiguous_dim0(t, self.dim)
        out = moved.new_empty((moved.shape[0] // self.n, *moved.shape[1:]))
        dist.reduce_scatter_tensor(out, moved, group=self.group)
        return out.movedim(0, self.dim).contiguous()


class Placement:
    """One leaf of full ``shape`` placed by ``spec`` on rank ``rank`` of
    ``mesh``, whose batch axes are ``batch``: ``model`` (its split over the
    axes that are not batch axes, or None) and ``data`` (its split over
    batch axes, applied to the model shard, or None)."""

    def __init__(self, shape: Sequence[int], spec, mesh, batch: Sequence[str],
                 rank: int):
        self.shape = tuple(shape)
        self.mesh = mesh
        coords = mesh.coords(rank)
        self.model: Optional[_Split] = None
        self.data: Optional[_Split] = None
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            names = tuple(a for a in names if mesh.shape[a] > 1)
            tp = tuple(a for a in names if a not in batch)
            dp = tuple(a for a in names if a in batch)
            if names != tp + dp:
                raise ValueError(f"spec {spec}: batch axes before a model "
                                 f"axis on one dim")
            for kind, axes in (("model", tp), ("data", dp)):
                if not axes:
                    continue
                if getattr(self, kind) is not None:
                    raise ValueError(f"spec {spec} of shape {self.shape} "
                                     f"splits two dims over {kind} axes")
                setattr(self, kind, _Split(dim, axes, mesh, coords))
        split = self.data.axes if self.data else ()
        self.replica_axes = tuple(a for a in batch if mesh.shape[a] > 1
                                  and a not in split)
        model_axes = tuple(a for a in mesh.axis_names if a not in batch
                           and mesh.shape[a] > 1)
        # This rank counts the leaf once in sums over all ranks (the global
        # grad norm) where it is the first of its batch replicas and, for a
        # leaf replicated over the model axis, on model rank 0.
        self.counts = all(coords[a] == 0 for a in self.replica_axes) and (
            self.model is not None or all(coords[a] == 0
                                          for a in model_axes))

    @property
    def n(self) -> int:
        """Shards of the leaf: model shards times batch shards."""
        return math.prod(s.n for s in (self.model, self.data) if s)

    @property
    def sharded(self) -> bool:
        return self.n > 1

    @property
    def model_shape(self) -> Tuple[int, ...]:
        """The shape of this rank's model shard (what the trainer holds
        under megatron and auto)."""
        s = list(self.shape)
        if self.model is not None:
            s[self.model.dim] //= self.model.n
        return tuple(s)

    def take_model(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's model shard of ``full`` (a view)."""
        return full if self.model is None else self.model.take(full)

    def take_data(self, mshard: torch.Tensor) -> torch.Tensor:
        """This rank's batch shard of its model shard ``mshard`` (a
        view)."""
        return mshard if self.data is None else self.data.take(mshard)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` (a view)."""
        return self.take_data(self.take_model(full))

    @property
    def replica_group(self):
        return self.mesh.group(self.replica_axes)

    def gather_data(self, shard: torch.Tensor) -> torch.Tensor:
        """The model shard from every batch rank's ``shard``."""
        return shard if self.data is None else self.data.gather(shard)

    def gather_model(self, mshard: torch.Tensor) -> torch.Tensor:
        """The full leaf from every model rank's model shard ``mshard``."""
        return mshard if self.model is None else self.model.gather(mshard)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's ``shard`` (all-gathers over the
        batch split, then the model split)."""
        return self.gather_model(self.gather_data(shard))

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the sum over the batch ranks of their
        ``g`` (each at :attr:`model_shape`; contiguous): a reduce-scatter
        over the batch split, then an all-reduce over the replica axes.
        An unsplit ``g`` is summed in place."""
        out = g if self.data is None else self.data.reduce(g)
        group = self.replica_group
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    def agree(self, shard: torch.Tensor) -> torch.Tensor:
        """``shard`` made equal across the batch replicas: the first
        replica's (broadcast), in place."""
        group = self.replica_group
        if group is not None:
            dist.broadcast(shard, dist.get_global_rank(group, 0), group=group)
        return shard


class GatherFn(torch.autograd.Function):
    """The gather of a sharded f32 master weight: forward casts the shard
    to ``dtype`` (or takes ``copy``, the shard already cast and gathered by
    the caller) and gathers it with ``gather`` (the whole weight, in the
    compute dtype); backward hands the f32 gradient of the whole weight to
    ``reduce``, whose result (the shard's gradient, or None when the caller
    keeps the gradient itself) becomes the shard's.  FSDP passes its
    placement's ``gather`` / ``reduce``; a model-split leaf outside the
    explicit blocks its model split's gather and :func:`chunk_of` (rule 3
    of the module docstring); a ZeRO-1 master its step's copy, gathered
    over data once a step."""

    @staticmethod
    def forward(ctx, shard, dtype,
                gather: Callable[[torch.Tensor], torch.Tensor],
                reduce: Callable[[torch.Tensor], Optional[torch.Tensor]],
                copy: Optional[torch.Tensor]):
        ctx.reduce = reduce
        return gather(shard.detach().to(dtype) if copy is None else copy)

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad.float()), None, None, None, None


def chunk_of(place: Placement):
    """The backward of a gather over ``place``'s model split: this rank's
    chunk of the whole gradient, which every model rank computed alike."""
    def reduce(grad: torch.Tensor) -> torch.Tensor:
        return place.take_model(grad).contiguous()
    return reduce
