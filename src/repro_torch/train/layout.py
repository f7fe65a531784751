"""Where each training leaf lives across data-parallel ranks, and the
collectives that move it.

A :class:`Placement` is one leaf's spec (:mod:`repro_torch.launch.sharding`)
applied to this rank under a parallelism's batch axes: the dim split over
``shard_axes`` (None: every rank holds the whole leaf), this rank's shard
``index`` of ``n``, and the batch axes of size > 1 over which the leaf is
replicated (``replica_axes``).  A mesh axis that is not a batch axis must
have size 1 here: tensor and expert parallelism over ``model`` wait for
ROADMAP 6c-ii.

The collectives are sums; callers divide by the number of batch ranks.
Group rank j holds shard j (the mesh's row-major order), which is the
order ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` use.
:class:`GatherFn` is FSDP's weight gather: forward all-gathers the shards
in the compute dtype, backward reduce-scatters the f32 gradient.
"""

from __future__ import annotations

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


class Placement:
    """One leaf of full ``shape`` placed by ``spec`` on rank ``rank`` of
    ``mesh``, whose batch axes are ``batch``."""

    def __init__(self, shape: Sequence[int], spec, mesh, batch: Sequence[str],
                 rank: int):
        self.shape = tuple(shape)
        self.mesh = mesh
        split = []
        for dim, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else tuple(entry or ())
            names = tuple(a for a in names if mesh.shape[a] > 1)
            if names:
                split.append((dim, names))
        if len(split) > 1:
            raise NotImplementedError(
                f"spec {spec} of shape {self.shape} splits two dims: tensor "
                f"parallelism waits for ROADMAP 6c-ii")
        self.dim, self.shard_axes = split[0] if split else (None, ())
        off_batch = [a for a in self.shard_axes + tuple(mesh.axis_names)
                     if a not in batch and mesh.shape[a] > 1]
        if off_batch:
            raise NotImplementedError(
                f"mesh axis {off_batch[0]!r} of size "
                f"{mesh.shape[off_batch[0]]} is not a batch axis: tensor / "
                f"expert parallelism waits for ROADMAP 6c-ii")
        self.replica_axes = tuple(a for a in batch if mesh.shape[a] > 1
                                  and a not in self.shard_axes)
        coords = mesh.coords(rank)
        self.n, self.index = 1, 0
        for a in self.shard_axes:
            self.n *= mesh.shape[a]
            self.index = self.index * mesh.shape[a] + coords[a]
        # This rank counts the leaf once in sums over batch ranks (the
        # global grad norm) where it is the first of its replicas.
        self.counts = all(coords[a] == 0 for a in self.replica_axes)

    @property
    def sharded(self) -> bool:
        return self.n > 1

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        if not self.sharded:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.n
        return tuple(s)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` (a view)."""
        if not self.sharded:
            return full
        size = self.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * size, size)

    @property
    def shard_group(self):
        return self.mesh.group(self.shard_axes)

    @property
    def replica_group(self):
        return self.mesh.group(self.replica_axes)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's ``shard`` (all-gather)."""
        if not self.sharded:
            return shard
        moved = _contiguous_dim0(shard, self.dim)
        out = moved.new_empty((moved.shape[0] * self.n, *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=self.shard_group)
        out = out.movedim(0, self.dim)
        return out if self.dim == 0 else out.contiguous()

    def reduce(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the sum of every batch rank's ``full``
        (contiguous): a reduce-scatter over the shard axes, then an
        all-reduce over the replica axes.  An unsharded ``full`` is summed
        in place."""
        out = full
        if self.sharded:
            moved = _contiguous_dim0(full, self.dim)
            out = moved.new_empty((moved.shape[0] // self.n,
                                   *moved.shape[1:]))
            dist.reduce_scatter_tensor(out, moved, group=self.shard_group)
            out = out.movedim(0, self.dim).contiguous()
        group = self.replica_group
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    def agree(self, shard: torch.Tensor) -> torch.Tensor:
        """``shard`` made equal across the replicas: the first replica's
        (broadcast), in place."""
        group = self.replica_group
        if group is not None:
            dist.broadcast(shard, dist.get_global_rank(group, 0), group=group)
        return shard


class GatherFn(torch.autograd.Function):
    """FSDP's gather of a sharded f32 master weight: forward casts the shard
    to ``dtype`` and all-gathers it (the whole weight, in the compute
    dtype); backward hands the f32 gradient of the whole weight to
    ``reduce``, whose result (the shard's gradient, or None when the caller
    keeps the whole gradient itself) becomes the shard's."""

    @staticmethod
    def forward(ctx, shard, dtype, place: Placement,
                reduce: Callable[[torch.Tensor], Optional[torch.Tensor]]):
        ctx.reduce = reduce
        return place.gather(shard.detach().to(dtype))

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad.float()), None, None, None
