"""Meshes of ranks for single-pod and multi-pod deployments.

Counterpart of the reference's ``launch/mesh.py`` over ``torch.distributed``.
A :class:`Mesh` is a named grid of ranks with the reference's shapes and
axis names: ``pod`` is pure data parallelism across pods, ``data`` in-pod
data parallelism, ``model`` the tensor / expert-parallel axis.  Rank r sits
at the row-major coordinates of r in the grid, as in
``torch.distributed.device_mesh.init_device_mesh``.

Building a mesh, and asking its ``axis_names`` and ``shape``, touches no
process group, so the sharding rules (:mod:`repro_torch.launch.sharding`)
stay pure functions of shapes.  Only :meth:`Mesh.device_mesh` and
:meth:`Mesh.group` (a rank's ``model`` group, its data group, or any set
of axes) need the default process group, and they raise unless it is
initialised with the mesh's size as its world size.
:func:`init_distributed` initialises it: NCCL for ``cuda``, gloo when the
caller asks for the CPU, or for gloo ranks sharing one card when it names
that backend.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """A grid of ranks: ``axis_names`` and ``shape`` ({name: size}, in axis
    order), as the reference's ``jax.sharding.Mesh`` exposes them."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self._device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on every axis (row-major)."""
        out = {}
        for ax in reversed(self.axis_names):
            rank, out[ax] = divmod(rank, self.shape[ax])
        return {ax: out[ax] for ax in self.axis_names}

    def _ranks(self, fixed: Dict[str, int], free: Sequence[str]):
        """The ranks whose coordinates equal ``fixed`` off the ``free``
        axes, in ascending order (row-major over ``free``)."""
        return [r for r in range(self.size)
                if all(v == fixed[a] for a, v in self.coords(r).items()
                       if a not in free)]

    def _require_world(self) -> None:
        if not dist.is_initialized():
            raise RuntimeError(f"{self}: no process group is initialised "
                               f"(launch/mesh.py init_distributed)")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"{self} has {self.size} ranks but the process "
                               f"group has {dist.get_world_size()}")

    def device_mesh(self):
        """The ``DeviceMesh`` of this grid over the initialised process group
        (built once, collectively: every rank must call it)."""
        self._require_world()
        if self._device_mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            self._device_mesh = init_device_mesh(
                kind, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axes: Sequence[str]):
        """The process group of this rank's ranks along ``axes`` (the ranks
        that share its coordinates on every other axis), or None when the
        axes' sizes multiply to 1.  Group rank j is the j-th of them in
        row-major order over ``axes``, which must be in mesh order.  One
        axis is the ``DeviceMesh``'s group; several are made with
        ``new_group``, collectively, once per set of axes."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if not axes:
            return None
        if list(axes) != [a for a in self.axis_names if a in axes]:
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        self._require_world()
        if axes not in self._groups:
            if len(axes) == 1:
                group = self.device_mesh().get_group(axes[0])
            elif math.prod(self.shape[a] for a in axes) == self.size:
                group = dist.group.WORLD
            else:
                # Every rank makes every group of the partition, in rank
                # order of their origins (coordinate 0 on `axes`).
                me, group = dist.get_rank(), None
                for r in range(self.size):
                    c = self.coords(r)
                    if any(c[a] for a in axes):
                        continue
                    ranks = self._ranks(c, axes)
                    g = dist.new_group(ranks)
                    if me in ranks:
                        group = g
            self._groups[axes] = group
        return self._groups[axes]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16 x 16 (data, model), or 2 x 16 x
    16 (pod, data, model) across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_elastic_mesh(n_devices: int, *, model: int = 16) -> Mesh:
    """Best mesh for an arbitrary surviving-device count (elastic restart).

    Keeps the model axis at the largest power-of-two divisor ≤ ``model`` so
    tensor-parallel weight shards stay local; the rest becomes data
    parallelism.
    """
    m = model
    while m > 1 and n_devices % m:
        m //= 2
    return Mesh((n_devices // m, m), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Whatever this job has: the initialised world's ranks, else one."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_elastic_mesh(n, model=min(4, n))


def init_distributed(device: str = "cuda", *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Initialise the default process group and return this rank's device.

    ``device="cuda"``: NCCL, on ``cuda:LOCAL_RANK`` (made current); raises
    without a CUDA device, never falling back to gloo.  ``device="cpu"``:
    gloo.  ``backend="gloo"`` with ``device="cuda"``: gloo ranks sharing
    one card, every rank on ``cuda:0`` (NCCL cannot put two ranks on one
    GPU); only when the caller names it.  ``rank``, ``world_size`` and
    ``init_method`` default to ``torchrun``'s environment (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT through ``env://``)."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for NCCL "
                               "(pass device='cpu' for gloo)")
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"init_distributed: backend {backend!r} for "
                             f"cuda is 'nccl' or 'gloo'")
        backend = backend or "nccl"
        local = 0 if backend == "gloo" else int(os.environ.get("LOCAL_RANK",
                                                               0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"init_distributed: backend {backend!r} for "
                             f"the CPU is 'gloo'")
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_distributed: unsupported device {device!r}")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]) if rank is None else rank,
        world_size=(int(os.environ["WORLD_SIZE"]) if world_size is None
                    else world_size))
    return dev
