"""Zamba2-style hybrid: Mamba-2 backbone plus one shared attention block.

Counterpart of the reference's ``models/hybrid.py``: prefill, decode and
the training stack (:func:`hybrid_stack_train`, without remat, as the
reference).
``n_layers`` Mamba-2 blocks; after every ``period`` of them a *single
shared* transformer block (attention + MLP, the same weights at each
invocation) runs.  Its KV cache is Mosaic-paged with one pool slice per
invocation (the activations differ per call even though the weights are
shared), so the pools are ``[G, NP, ptok, n_kv, dh]``.  Leftover Mamba
layers (``n_layers % period``) form a trailing group.

Prefill runs the shared block's attention through the flash-attention
kernel and scatters its K/V into pool slice ``g``; decode runs it through
the paged (or, with staged pages, the fused) decode kernel.  Fused decode
hands each invocation its own slice of the layer-stacked stage.  The
reference's hybrid decode hands every invocation the whole stack
(``repro/models/hybrid.py:168-169``) and so fails once a fused step stages
pages; the port slices per invocation, as its dense stack does per layer.

Over a serving mesh (``par``) the Mamba-2 layers run on the rank's heads
(:mod:`repro_torch.models.mamba2`) and the shared block through the dense
mesh path: its attention and SwiGLU at the rank's heads and hidden shard,
its K/V written into the rank's stripe of pool slice g at prefill, its
decode attention over that stripe with the cross-rank combine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ParallelCtx,
    empty_param,
    train_weight,
    unbind_layers,
)
from repro_torch.models.layers import rms_norm
from repro_torch.models.mamba2 import (
    MambaParams,
    mamba_block_decode,
    mamba_block_train,
)
from repro_torch.models.page_ops import PageCtx, prefill_write_op
from repro_torch.models.transformer import (
    AttnParams,
    FFNParams,
    attn_block_decode,
    attn_block_train,
    ffn_block,
    serving_attn_prefill,
)


def group_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(G invocations of the shared block, period, leftover layers)."""
    period = cfg.hybrid.period
    G = cfg.n_layers // period
    leftover = cfg.n_layers - G * period
    return G, period, leftover


def n_invocations(cfg: ModelConfig) -> int:
    return group_shape(cfg)[0]


class SharedBlockParams(nn.Module):
    """The shared transformer block, without a layer axis: ln1, ln2 [d],
    attn (wq [d,H,dh], ...), mlp (w_gate [d,f], ...)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = empty_param((cfg.d_model,), dtype, device)
        self.ln2 = empty_param((cfg.d_model,), dtype, device)
        self.attn = AttnParams(cfg, None, dtype, device)
        self.mlp = FFNParams(cfg, None, dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln1.data.fill_(1.0)
        self.ln2.data.fill_(1.0)
        self.attn.init_(gen)
        self.mlp.init_(gen)


class HybridParams(nn.Module):
    """The reference's ``init_hybrid_params`` tree: mamba_ln [G, period, d],
    mamba (Mamba-2 weights [G, period, ...]), shared, and with leftover
    layers tail_ln [leftover, d] and tail ([leftover, ...])."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        G, period, leftover = group_shape(cfg)
        self.mamba_ln = empty_param((G, period, cfg.d_model), dtype, device)
        self.mamba = MambaParams(cfg, (G, period), dtype, device)
        self.shared = SharedBlockParams(cfg, dtype, device)
        if leftover:
            self.tail_ln = empty_param((leftover, cfg.d_model), dtype,
                                       device)
            self.tail = MambaParams(cfg, (leftover,), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.mamba_ln.data.fill_(1.0)
        self.mamba.init_(gen)
        self.shared.init_(gen)
        if hasattr(self, "tail"):
            self.tail_ln.data.fill_(1.0)
            self.tail.init_(gen)

    def shared_tree(self):
        """The shared block's weights as the reference's tree."""
        sp = self.shared
        return {"ln1": sp.ln1, "ln2": sp.ln2,
                "attn": dict(sp.attn.named_parameters()),
                "mlp": dict(sp.mlp.named_parameters())}

    def train_tree(self, dtype):
        """The training forward's weights, as :meth:`mamba_layers` and
        :meth:`shared_tree` give them, cast to ``dtype``: the grouped and
        tail Mamba-2 weights each cast once and unbound along their layer
        axes (:func:`unbind_layers`), the shared block's cast once (its
        gradient sums over the G invocations).  Returns (groups, tail,
        shared)."""
        G, period = self.mamba_ln.shape[:2]
        flat = unbind_layers(
            [("ln", train_weight(self.mamba_ln, dtype).flatten(0, 1))]
            + [(n, train_weight(p, dtype).flatten(0, 1))
               for n, p in self.mamba.named_parameters()],
            dtype, G * period)
        groups = [[(lp, lp.pop("ln")) for lp in flat[g * period:
                                                    (g + 1) * period]]
                  for g in range(G)]
        tail = []
        if hasattr(self, "tail"):
            tail = [(lp, lp.pop("ln")) for lp in unbind_layers(
                [("ln", self.tail_ln), *self.tail.named_parameters()], dtype,
                self.tail_ln.shape[0])]
        shared = {k: ({n: train_weight(w, dtype) for n, w in v.items()}
                      if isinstance(v, dict) else train_weight(v, dtype))
                  for k, v in self.shared_tree().items()}
        return groups, tail, shared

    def mamba_layers(self):
        """(layer weights, norm weight) of every Mamba-2 layer in order,
        grouped: G groups of ``period``, then the tail (possibly empty)."""
        G, period = self.mamba_ln.shape[:2]
        groups = [[(self.mamba.layer(g, j), self.mamba_ln[g, j])
                   for j in range(period)] for g in range(G)]
        tail = ([(self.tail.layer(j), self.tail_ln[j])
                 for j in range(self.tail_ln.shape[0])]
                if hasattr(self, "tail") else [])
        return groups, tail


def _shared_block_prefill(cfg: ModelConfig, sp, x, positions, pools,
                          ctx: PageCtx, g: int,
                          par: Optional[ParallelCtx] = None):
    """The shared block at invocation ``g``: its K/V go to pool slice g
    (over a mesh: this rank's stripe of it)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    a, k, v = serving_attn_prefill(cfg, sp["attn"], h, positions, par)
    prefill_write_op(k, v, pools[0][g], pools[1][g], ctx, par=par)
    x = x + a
    return x + ffn_block(cfg, sp["mlp"], rms_norm(x, sp["ln2"],
                                                  cfg.norm_eps), par)


def _shared_block_train(cfg: ModelConfig, sp, x, positions, par=None):
    """The shared block's training forward (the reference's, without
    pools; its attention and SwiGLU explicit blocks under ``par``)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    x = x + attn_block_train(cfg, sp["attn"], h, positions, par=par)[0]
    return x + ffn_block(cfg, sp["mlp"], rms_norm(x, sp["ln2"],
                                                  cfg.norm_eps), par)


def hybrid_stack_train(cfg: ModelConfig, tree, x, positions, par=None):
    """The hybrid stack's training forward over the weights of
    :meth:`HybridParams.train_tree`.  Nothing is recomputed in the
    backward: the reference's ``LM.loss`` passes no ``remat`` to its
    ``hybrid_stack_train``, whose Mamba-2 scans and shared block keep
    every activation, and the port keeps that behaviour.  ``par``: a
    training forward's ranks (the Mamba-2 layers run whole on every model
    rank, their leaves gathered)."""
    groups, tail, sp = tree
    for group in groups:
        for lp, ln in group:
            x = x + mamba_block_train(cfg, lp, rms_norm(x, ln, cfg.norm_eps))
        x = _shared_block_train(cfg, sp, x, positions, par)
    for lp, ln in tail:
        x = x + mamba_block_train(cfg, lp, rms_norm(x, ln, cfg.norm_eps))
    return x


def hybrid_stack_prefill(cfg: ModelConfig, params: HybridParams, x,
                         positions, pools, ctx: PageCtx,
                         par: Optional[ParallelCtx] = None):
    """Returns (x, pools, ssm_states [L,B,nh,hd,N], conv_states
    [L,B,K-1,cd]); the pools are written in place.  ``par``: a serving
    mesh (module docstring)."""
    groups, tail = params.mamba_layers()
    sp = params.shared_tree()
    hs, convs = [], []

    def mamba(x, lp, ln):
        y, (h, conv) = mamba_block_train(
            cfg, lp, rms_norm(x, ln, cfg.norm_eps), return_state=True,
            par=par)
        hs.append(h)
        convs.append(conv)
        return x + y

    for g, group in enumerate(groups):
        for lp, ln in group:
            x = mamba(x, lp, ln)
        x = _shared_block_prefill(cfg, sp, x, positions, pools, ctx, g, par)
    for lp, ln in tail:
        x = mamba(x, lp, ln)
    return x, pools, torch.stack(hs), torch.stack(convs)


def hybrid_stack_decode(cfg: ModelConfig, params: HybridParams, x, pos,
                        pools, ctx: PageCtx, ssm_state, conv_state,
                        par: Optional[ParallelCtx] = None):
    """Decode: recurrent Mamba-2 updates plus paged shared-block attention.

    ssm_state [L, B, nh, hd, N]; conv_state [L, B, d_conv-1, conv_dim];
    pools (k [G, NP, ...], v [G, NP, ...]), written in place.  Returns
    (x, pools, ssm_state', conv_state').  ``par``: a serving mesh (module
    docstring; the states are the rank's heads and channels)."""
    groups, tail = params.mamba_layers()
    sp = params.shared_tree()
    k_pools, v_pools = pools
    hs, convs = [], []

    def mamba(x, lp, ln):
        l = len(hs)
        y, h, conv = mamba_block_decode(
            cfg, lp, rms_norm(x, ln, cfg.norm_eps), ssm_state[l],
            conv_state[l], par)
        hs.append(h)
        convs.append(conv)
        return x + y

    for g, group in enumerate(groups):
        for lp, ln in group:
            x = mamba(x, lp, ln)
        h = rms_norm(x, sp["ln1"], cfg.norm_eps)
        # Staged pages arrive invocation-stacked; each reads its slice.
        x = x + attn_block_decode(cfg, sp["attn"], h, pos, k_pools[g],
                                  v_pools[g], ctx.stage_at(g), par)
        x = x + ffn_block(cfg, sp["mlp"], rms_norm(x, sp["ln2"],
                                                   cfg.norm_eps), par)
    for lp, ln in tail:
        x = mamba(x, lp, ln)
    return x, pools, torch.stack(hs), torch.stack(convs)
