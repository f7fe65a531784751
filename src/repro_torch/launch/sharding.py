"""Parameter / optimizer sharding rules (TP + EP + ZeRO-1, FSDP).

Counterpart of the reference's ``launch/sharding.py`` on the port's dotted
parameter names (``decoder.attn.wq``, ``decoder.moe.w_gate``, ``embed``).
Specs are matched by the leaf name (after the last dot) against trailing
dimensions, so the same rule covers a stacked ``[L, ...]`` tensor, a
hybrid's ``[G, P, ...]`` grouping, or an unstacked shared block; the MoE
expert rules apply where ``moe`` is a component of the name.

A spec is a tuple with one entry per dim, each an axis name, a tuple of
axis names or None, as a ``PartitionSpec``; ``()`` is replicated.  Every
function here is pure: it reads a mesh's ``axis_names`` and ``shape`` and
the leaves' shapes, and touches no process group.  ``params`` is a mapping
from names to anything with a ``shape`` (tensors, meta tensors).

:func:`serving_shard` cuts one rank's serving shard from whole parameters
(``serving_param_specs`` applied through ``train/layout.py``'s
:class:`~repro_torch.train.layout.Placement`, the 2-D expert layout where
``models/moe.py::ep2d_geometry`` applies, and the Mamba-2 leaves cut by
heads, :class:`HeadCut`) and :func:`serving_lm` builds the LM that holds
it; :func:`shard_shape` is a spec's per-rank shape.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# name -> trailing-dims spec (leading dims padded with None).
_TRAILING_RULES: Dict[str, Spec] = {
    # embeddings
    "embed": ("model", None),
    "unembed": (None, "model"),
    "frontend_proj": (None, None),
    # attention (GQA): column-parallel QKV, row-parallel O
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, "model", None),
    "wo": ("model", None, None),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "w_dkv": (None, None),
    "w_kr": (None, None),
    "kv_norm": (None,),
    "w_uk": (None, "model", None),
    "w_uv": (None, "model", None),
    # dense FFN
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    # MoE (EP: experts over model axis; router replicated)
    "router": (None, None),
    "ws_gate": (None, "model"),
    "ws_up": (None, "model"),
    "ws_down": ("model", None),
    # Mamba2 (head-major inner dim sharded; scalars replicated)
    "w_in": (None, "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "norm_w": ("model",),
    "w_out": ("model", None),
}

# MoE expert tensors carry an extra leading E dim that is itself sharded.
_MOE_EXPERT_RULES: Dict[str, Spec] = {
    "w_gate": ("model", None, None),
    "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}

# Serving layout for MoE expert tensors: 2D EP — experts over 'data',
# expert-hidden over 'model'.  All other params keep the TP rules.
_MOE_EXPERT_SERVING_RULES: Dict[str, Spec] = {
    "w_gate": ("data", None, "model"),
    "w_up": ("data", None, "model"),
    "w_down": ("data", "model", None),
}


def _leaf_name(name: str) -> Tuple[str, Tuple[str, ...]]:
    keys = tuple(name.split("."))
    return keys[-1], keys


def _apply(rule: Spec, shape, mesh) -> Spec:
    """``rule`` on the trailing dims of ``shape``; axes absent from the mesh
    or not dividing their dim are dropped."""
    full = (None,) * (len(shape) - len(rule)) + tuple(rule)
    names = set(mesh.axis_names)
    return tuple(ax if ax is not None and ax in names
                 and dim % mesh.shape[ax] == 0 else None
                 for dim, ax in zip(shape, full))


def spec_for(name: str, shape, mesh) -> Spec:
    """The tensor / expert-parallel spec of the leaf ``name`` of ``shape``."""
    leaf, keys = _leaf_name(name)
    rule: Optional[Spec] = None
    if "moe" in keys and leaf in _MOE_EXPERT_RULES:
        rule = _MOE_EXPERT_RULES[leaf]
    elif leaf in _TRAILING_RULES:
        rule = _TRAILING_RULES[leaf]
    if rule is None or len(shape) < len(rule):
        return ()
    return _apply(rule, tuple(shape), mesh)


def param_specs(params: Mapping, mesh) -> Dict[str, Spec]:
    """{name: spec} matching ``params``."""
    return {n: spec_for(n, tuple(p.shape), mesh) for n, p in params.items()}


def zero1_extend(spec: Spec, shape, mesh) -> Spec:
    """Add the data axes to the largest unsharded divisible dim (ZeRO-1)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not dp:
        return spec
    dp_size = math.prod(mesh.shape[a] for a in dp)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # Prefer the largest dim with no axis yet (stable order on ties).
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % dp_size == 0:
            entries[i] = dp if len(dp) > 1 else dp[0]
            return tuple(entries)
        if entries[i] is not None and not isinstance(entries[i], tuple):
            ax = entries[i]
            if shape[i] % (mesh.shape[ax] * dp_size) == 0:
                entries[i] = (ax, *dp)
                return tuple(entries)
    return spec


def zero1_specs(params: Mapping, mesh) -> Dict[str, Spec]:
    base = param_specs(params, mesh)
    return {n: zero1_extend(base[n], tuple(p.shape), mesh)
            for n, p in params.items()}


def fsdp_spec_for(shape, mesh) -> Spec:
    """ZeRO-3: shard the largest divisible dim over every mesh axis.

    Falls back to progressively smaller axis subsets (drop 'pod', then
    'data') so awkward dims still shard as much as possible; fully
    replicated only as a last resort.
    """
    axes_all = tuple(a for a in ("pod", "data", "model")
                     if a in mesh.axis_names)
    for drop in range(len(axes_all)):
        axes = axes_all[drop:]
        n = math.prod(mesh.shape[a] for a in axes)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n == 0 and shape[i] >= n:
                entries: list = [None] * len(shape)
                entries[i] = axes if len(axes) > 1 else axes[0]
                return tuple(entries)
    return ()


def fsdp_specs(params: Mapping, mesh) -> Dict[str, Spec]:
    """{name: fully-sharded (ZeRO-3) spec}."""
    return {n: fsdp_spec_for(tuple(p.shape), mesh) for n, p in params.items()}


def serving_param_specs(params: Mapping, mesh, ep2d: bool) -> Dict[str, Spec]:
    """Param specs for inference; ``ep2d`` switches expert tensors to the
    2D expert-parallel layout."""
    base = param_specs(params, mesh)
    if not ep2d:
        return base
    out = dict(base)
    for n, p in params.items():
        leaf, keys = _leaf_name(n)
        if "moe" in keys and leaf in _MOE_EXPERT_SERVING_RULES:
            out[n] = _apply(_MOE_EXPERT_SERVING_RULES[leaf], tuple(p.shape),
                            mesh)
    return out


# Serving's batch axes: the batch rows, and the 2-D EP's experts, split
# over them; ``model`` carries TP, EP and the page stripes.
SERVING_BATCH_AXES = ("pod", "data")


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-rank shape of a leaf of ``shape`` under ``spec`` (each dim
    divided by the sizes of its axes: ``NamedSharding.shard_shape``)."""
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        out.append(dim // math.prod(mesh.shape[a] for a in axes))
    return tuple(out)


class HeadCut:
    """A Mamba-2 leaf's serving placement: the ranges of one dim
    (``models/mamba2.py::head_ranges``) holding model rank ``rank``'s
    heads.  The reference's rule cuts these leaves contiguously, which
    would give one rank all of ``w_in``'s ``z`` columns and part of its
    ``x``; a spec cannot say this cut, so :meth:`take` and
    :attr:`shard_shape` do."""

    def __init__(self, shape, dim: int, ranges):
        self.shape = tuple(shape)
        self.dim = dim % len(self.shape)
        self.ranges = tuple(ranges)

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        out = list(self.shape)
        out[self.dim] = sum(hi - lo for lo, hi in self.ranges)
        return tuple(out)

    def take(self, full):
        """This rank's shard of ``full`` (extra leading dims allowed: the
        ranges index ``full``'s dim counted from the end)."""
        dim = self.dim - len(self.shape)
        parts = [full.narrow(dim, lo, hi - lo) for lo, hi in self.ranges]
        if len(parts) == 1:
            return parts[0]
        import torch
        return torch.cat(parts, dim=dim)


def head_cut(cfg, name: str, shape, mesh, rank: int) -> Optional[HeadCut]:
    """The :class:`HeadCut` of the Mamba-2 leaf ``name`` on ``rank`` of
    ``mesh``, or None (not a Mamba-2 leaf, or a ``model`` axis of 1).
    Raises where the heads cannot split over ``model``
    (``models/mamba2.py::heads_split``)."""
    from repro_torch.models.mamba2 import head_ranges, heads_split
    leaf, keys = _leaf_name(name)
    tp = mesh.shape.get("model", 1)
    if cfg.ssm is None or not ({"mamba", "tail"} & set(keys)) \
            or not heads_split(cfg, tp):
        return None
    cut = head_ranges(cfg, leaf, tp, mesh.coords(rank).get("model", 0))
    return None if cut is None else HeadCut(shape, *cut)


def serving_placements(cfg, params: Mapping, mesh, rank: int):
    """{name: Placement} of rank ``rank``'s serving shard of ``params``
    (TP rules, the 2-D EP layout for expert tensors when it applies; a
    :class:`HeadCut` for the Mamba-2 leaves)."""
    from repro_torch.models.moe import ep2d_geometry
    from repro_torch.train.layout import Placement
    batch = tuple(a for a in mesh.axis_names if a in SERVING_BATCH_AXES)
    specs = serving_param_specs(params, mesh,
                                ep2d_geometry(cfg, mesh) is not None)
    return {n: head_cut(cfg, n, tuple(p.shape), mesh, rank)
            or Placement(tuple(p.shape), specs[n], mesh, batch, rank)
            for n, p in params.items()}


def serving_shard(cfg, params: Mapping, mesh, rank: int) -> Dict:
    """Rank ``rank``'s serving shard of whole ``params`` ({name: tensor}):
    each leaf cut by :func:`serving_placements` (a contiguous copy)."""
    places = serving_placements(cfg, params, mesh, rank)
    return {n: places[n].take(p).contiguous().clone()
            for n, p in params.items()}


def serving_lm(cfg, shards: Mapping, device="cpu"):
    """An LM of ``cfg`` that holds ``shards`` (:func:`serving_shard`'s
    output, or any {name: tensor} at the shard shapes) as its weights, in
    ``cfg.dtype`` on ``device``: built on the meta device, each weight
    then replaced by its shard."""
    import torch
    from torch import nn
    from repro_torch.models.lm import LM
    lm = LM(cfg, device="meta")
    dtype = getattr(torch, cfg.dtype)
    names = dict(lm.named_parameters())
    if set(names) != set(shards):
        raise ValueError(f"shards miss {sorted(set(names) - set(shards))} "
                         f"and add {sorted(set(shards) - set(names))}")
    for name, t in shards.items():
        owner, _, leaf = name.rpartition(".")
        setattr(lm.get_submodule(owner), leaf, nn.Parameter(
            t.to(device=device, dtype=dtype), requires_grad=False))
    return lm
