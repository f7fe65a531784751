"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch.

Counterpart of the single-device path of the reference's ``models/moe.py``
(``moe_block`` without a mesh: ``_moe_routed`` over every expert plus
``_moe_shared``).  Used by deepseek-v2-lite (64 routed top-6 + 2 shared,
first layer dense) and dbrx (16 routed top-4).

Per sequence (GShard-style): each token's top-k experts come from an f32
softmax over the router logits, ties broken toward the lower expert index
(as ``jax.lax.top_k``); its position in an expert's buffer is the running
count of that expert's selections over the sequence, and positions at or
past the capacity C = ceil(S · top_k / E · capacity_factor) are dropped.
``S`` is the whole forward's length: a prompt the engine right-pads to a
page multiple with token 0 spends capacity on the pad tokens, as in the
reference.  The experts run as batched matrix products over the experts;
no TPU kernel exists for them.

Training differentiates the block as the reference's: the router's
gradient flows through the gates (the top-k values of the softmax, which
``torch.sort`` keeps differentiable, as ``jax.lax.top_k``) and through
``me`` in the aux loss; ``fe`` and the capacity positions are counts and
carry none.  The dispatch (``index_copy_``) writes each kept slot once and
its backward gathers; the combine (``index_select``) reads each kept slot
once, so its backward (an ``index_add_``) sums one row into each.  Only
the dropped entries share an address, slot C, and they carry exact zeros:
two backward runs give the same bits on the card, with or without
``torch.use_deterministic_algorithms``.

Under data parallelism (each rank holding its rows of the batch) the
load-balance loss spans the whole batch, as the reference's shard_map path
computes it (``E · Σ mean_dp(me) · mean_dp(fe)``): each rank all-reduces
its expert loads ``fe`` over its data group only (counts, no gradient)
and returns ``E · Σ me_r · fe_dp``, whose mean over the ranks, and its
gradient's, are the reference's.  Capacity is per row, so it does not
change.

Over a ``model`` axis of tp > 1 under megatron the block is the
reference's training EP (``moe_block``'s ``shard_map``): a rank holds
experts [e0, e0 + E / tp) (w_gate / w_up / w_down split on the expert
dim), routes over all E with the replicated router (x and the router by
copy-to-model), drops the entries bound for other ranks' experts as it
drops those over capacity (exact zeros, so two backwards stay bitwise),
and returns a partial y reduced over ``model``; the shared experts run as
a TP SwiGLU with their own reduce.  Every model rank computes the same
aux, whose gradient the copies' all-reduces would count tp times: it
leaves the block through ``replicated_out``.

Serving over a mesh with a ``data`` axis > 1 (:func:`ep2d_geometry`) runs
the reference's 2-D expert parallelism (``_moe_block_serving``): the
experts are split over ``data`` and their hidden dim over ``model``
(``launch/sharding.py``'s serving rules).  Decode (T = 1) gathers every
row of the batch, runs each row through this rank's experts at its hidden
shard, dense-masked by the gates (at T = 1 no entry exceeds capacity, so
this is the capacity dispatch's result), and sums over the (data, model)
grid; the shared experts are added once, by the ranks of data rank 0 (the
reference adds them on every data rank, ROADMAP Queue 3).  Prefill
gathers the experts' weights over ``data`` and dispatches this rank's rows
locally at its hidden shard, one sum over ``model``.  At a ``data`` axis
of 1, serving takes the training EP above on this rank's own experts.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ParallelCtx,
    dense_init_,
    empty_param,
    explicit,
    gather_dim,
    merge_parts,
)


class MoEParams(nn.Module):
    """Routed (and shared) expert weights stacked over layers, in the
    reference's shapes: router [L, d, E], w_gate / w_up [L, E, d, fe],
    w_down [L, E, fe, d]; with ``n_shared`` also ws_gate / ws_up
    [L, d, n_shared · fe] and ws_down [L, n_shared · fe, d]."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        mo = cfg.moe
        d, fe, E = cfg.d_model, mo.d_expert, mo.n_experts
        self.router = empty_param((L, d, E), dtype, device)
        self.w_gate = empty_param((L, E, d, fe), dtype, device)
        self.w_up = empty_param((L, E, d, fe), dtype, device)
        self.w_down = empty_param((L, E, fe, d), dtype, device)
        if mo.n_shared:
            fs = mo.n_shared * fe
            self.ws_gate = empty_param((L, d, fs), dtype, device)
            self.ws_up = empty_param((L, d, fs), dtype, device)
            self.ws_down = empty_param((L, fs, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        """The reference's ``init_moe_params`` distributions (fan-in over
        d for the router, gates and ups, over fe for the downs), drawn one
        layer at a time so that the f32 draw of a full-width expert stack
        never sits on the card whole."""
        for name, p in self.named_parameters():
            in_axis = 1 if name in ("w_gate", "w_up", "w_down") else 0
            for l in range(p.shape[0]):
                dense_init_(p[l], in_axis, gen)


def ep2d_geometry(cfg: ModelConfig, mesh):
    """2-D expert-parallel geometry for *serving*, or None (the
    reference's ``ep2d_geometry``): experts over 'data', expert-hidden over
    'model'.  ``mesh``: anything with a ``shape`` mapping of axis sizes (a
    :class:`~repro_torch.launch.mesh.Mesh`, a serving
    :class:`~repro_torch.models.common.ParallelCtx`).  Returns (E_loc,
    fe_loc)."""
    mo = cfg.moe
    if mo is None or mesh is None:
        return None
    d_sz = mesh.shape.get("data", 1)
    tp = mesh.shape.get("model", 1)
    if d_sz <= 1 or mo.n_experts % d_sz or mo.d_expert % tp:
        return None
    return mo.n_experts // d_sz, mo.d_expert // tp


def capacity(S: int, E: int, top_k: int, cf: float) -> int:
    return max(1, math.ceil(S * top_k / E * cf))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    equal values in index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """Router and capacity assignment of x [G, S, d].

    Returns (probs [G,S,E] f32, gates [G,S,K] f32 renormalised, sel
    [G,S,K] expert ids, pos [G,S,K] position in the expert's buffer, keep
    [G,S,K] pos < C, C)."""
    mo = cfg.moe
    G, S, _d = x.shape
    E, K = mo.n_experts, mo.top_k
    C = capacity(S, E, K, mo.capacity_factor)
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, sel = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(sel, E).sum(2)                       # [G, S, E]
    cum = torch.cumsum(onehot, dim=1)                       # inclusive
    pos = torch.gather(cum, 2, sel) - 1                     # [G, S, K]
    return probs, gates, sel, pos, pos < C, C


def _moe_routed(cfg: ModelConfig, p, x, e0: int = 0):
    """Routed experts over x [G, S, d] with this rank's experts [e0, e0 +
    E_local) (E_local: ``p["w_gate"]``'s first dim): (y [G, S, d], the
    partial sum over the local experts; me [E], fe [E] over all E)."""
    mo = cfg.moe
    G, S, d = x.shape
    E, K = mo.n_experts, mo.top_k
    E_local = p["w_gate"].shape[0]
    probs, gates, sel, pos, keep, C = route(cfg, p["router"], x)
    me = probs.mean(dim=(0, 1))
    fe = torch.bincount(sel.reshape(-1), minlength=E).float() / sel.numel()

    # Dispatch into [G, E_local, C + 1, d]: slot C collects the dropped
    # entries (over capacity, or another rank's expert: those land in
    # expert 0's) and is cut off before the experts run.  Kept slots are
    # unique, so each receives exactly its token's row.
    if E_local != E:
        keep = keep & (sel >= e0) & (sel < e0 + E_local)
        sel = torch.where(keep, sel - e0, 0)
    pos_k = torch.where(keep, pos, C)
    g_idx = torch.arange(G, device=x.device)[:, None, None]
    slot = ((g_idx * E_local + sel) * (C + 1) + pos_k).reshape(-1)
    rows = (x[:, :, None, :] * keep[..., None].to(x.dtype)).reshape(-1, d)
    xs = x.new_zeros((G * E_local * (C + 1), d)).index_copy_(0, slot, rows)
    xs = xs.view(G, E_local, C + 1, d)[:, :, :C]

    # Expert SwiGLU, one batched product per weight over the experts.
    xe = xs.transpose(0, 1).reshape(E_local, G * C, d)
    h = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(h.float()).to(x.dtype) * u
    ys = torch.bmm(h, p["w_down"]).view(E_local, G, C, d).transpose(0, 1)

    # Gather back; dropped entries read the zero slot C.
    ys = torch.cat([ys, ys.new_zeros((G, E_local, 1, d))], dim=2)
    out_k = ys.reshape(-1, d).index_select(0, slot).view(G, S, K, d)
    w = (gates * keep).to(x.dtype)
    y = torch.einsum("gskd,gsk->gsd", out_k, w)
    return y, me, fe


def _moe_shared(p, x):
    """Always-on shared experts (one SwiGLU over n_shared · fe)."""
    g = x @ p["ws_gate"]
    u = x @ p["ws_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["ws_down"]


def moe_parts(cfg: ModelConfig, p: Dict[str, torch.Tensor], x,
              par: Optional[ParallelCtx] = None
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """x [B, T, d] -> (the block's partial outputs: routed, then shared
    experts; Switch load-balance aux loss).

    ``par``: the ranks the forward runs over (None: one device): the aux
    loss takes the expert loads of its data group's rows, and an explicit
    ``par`` runs the training EP on this rank's experts (module
    docstring), each partial output then pending its reduce over
    ``model`` (:func:`moe_block`; ``decoder_stack_train``'s
    ``save_collectives`` reduces them outside its checkpoint)."""
    mo = cfg.moe
    ep = explicit(par)
    e0 = 0
    if ep:
        if mo.n_experts % par.tp:
            raise ValueError(f"n_experts={mo.n_experts} not divisible by "
                             f"model={par.tp}")
        e0 = par.model_rank * (mo.n_experts // par.tp)
        x = par.copy_to_model(x)
        p = dict(p, router=par.copy_to_model(p["router"]))
    y, me, fe = _moe_routed(cfg, p, x, e0)
    group = None if par is None else par.dp_group
    if group is not None:
        dist.all_reduce(fe, group=group)
        fe = fe / dist.get_world_size(group)
    parts: List[torch.Tensor] = [y]
    if mo.n_shared:
        parts.append(_moe_shared(p, x))
    aux = mo.n_experts * torch.sum(me * fe)
    return parts, par.replicated_out(aux) if ep else aux


def moe_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x,
              par: Optional[ParallelCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], Switch load-balance aux loss): the
    partial outputs of :func:`moe_parts`, each reduced over ``model`` under
    the training EP, summed; over a serving mesh with a 2-D geometry (a
    ``data`` axis: only :func:`~repro_torch.models.common.serving_ctx`
    sets one), the serving 2-D EP (aux 0, as the reference's decode; the
    module docstring)."""
    if par is not None and ep2d_geometry(cfg, par) is not None:
        return _moe_block_serving(cfg, p, x, par)
    parts, aux = moe_parts(cfg, p, x, par)
    return merge_parts(par, parts, explicit(par)), aux


def _adds_shared(cfg: ModelConfig, p, par: ParallelCtx, over_data: bool
                 ) -> bool:
    """Whether this rank adds the shared experts to its partial rows, so
    that the sum counts them once: each model rank its hidden shard (or
    model rank 0 alone when the hidden dim is not split), and, when the
    sum also runs over ``data`` (``over_data``: decode), data rank 0
    alone."""
    mo = cfg.moe
    if not mo.n_shared:
        return False
    split = p["ws_gate"].shape[-1] < mo.n_shared * mo.d_expert
    return (split or par.model_rank == 0) and not (over_data
                                                   and par.data_rank)


def _moe_block_serving(cfg: ModelConfig, p, x, par: ParallelCtx):
    """The serving 2-D EP over this rank's experts [e0, e0 + E_loc) at its
    hidden shard (module docstring): decode at T = 1, prefill otherwise."""
    mo = cfg.moe
    E_loc, fe_loc = ep2d_geometry(cfg, par)
    if p["w_gate"].shape[0] != E_loc or p["w_gate"].shape[-1] != fe_loc:
        raise ValueError(f"expert weights {tuple(p['w_gate'].shape)} are not "
                         f"the 2-D EP shard ({E_loc}, d, {fe_loc})")
    if x.shape[1] == 1:
        xg = x[:, 0, :]
        if par.batch_sharded:
            xg = gather_dim(xg, 0, par.dp_group, par.dp_size)
        _probs, gates, sel, _pos, _keep, _C = route(cfg, p["router"],
                                                    xg[None])
        gate_full = torch.zeros((xg.shape[0], mo.n_experts),
                                dtype=torch.float32, device=x.device)
        gate_full.scatter_add_(1, sel[0], gates[0])
        e0 = par.data_rank * E_loc
        g_loc = gate_full[:, e0:e0 + E_loc].to(x.dtype)
        # Dense-masked SwiGLU of every row over the resident experts.
        h = torch.einsum("bd,edf->bef", xg, p["w_gate"])
        u = torch.einsum("bd,edf->bef", xg, p["w_up"])
        h = F.silu(h.float()).to(x.dtype) * u
        ye = torch.einsum("bef,efd->bed", h, p["w_down"])
        y = torch.einsum("bed,be->bd", ye, g_loc)
        if _adds_shared(cfg, p, par, over_data=True):
            y = y + _moe_shared(p, xg)
        if par.expert_group is not None:
            y = y.contiguous()
            dist.all_reduce(y, group=par.expert_group)
        if par.batch_sharded:
            y = par.rows(y)
        return y[:, None, :], torch.zeros((), dtype=torch.float32,
                                          device=x.device)
    pl = dict(p)
    for name in ("w_gate", "w_up", "w_down"):
        pl[name] = gather_dim(p[name], 0, par.data_group, par.data_size)
    y, me, fe = _moe_routed(cfg, pl, x, 0)
    if _adds_shared(cfg, p, par, over_data=False):
        y = y + _moe_shared(p, x)
    if par.model_group is not None:
        y = par.reduce_from_model(y)
    return y, mo.n_experts * torch.sum(me * fe)
