"""Encoder–decoder stack (seamless-m4t-large-v2 backbone).

Counterpart of the reference's ``models/encdec.py`` for serving.  The
encoder is a bidirectional transformer over the frontend's frame
embeddings; the decoder runs causal self-attention, whose K/V is paged in
the pools like the dense stack's, then cross-attention to the encoder
memory, then SwiGLU.  Cross K/V are computed once per layer at prefill and
kept densely as decode state (``cross_k`` / ``cross_v`` [L, B, S, n_kv,
dh]), as the reference does.

Every attention runs the flash-attention kernel (plain version on CPU
tensors): the encoder's non-causal over S frames, the decoder's causal
self-attention at prefill, and the cross-attention non-causal with the
decoder rows as queries over the S memory rows, at prefill and at decode
(one query row a sequence).  Decode's self-attention is the paged kernel,
or the fused gather-attend kernel when the step carries staged pages; each
layer reads its own slice of the layer-stacked stage.  The reference's
encdec decode hands every layer the whole stack
(``repro/models/encdec.py:150-151``) and so fails once a fused step stages
pages; the port slices per layer, as its dense and hybrid stacks do.

Parameter names follow the reference's tree (``encoder.attn.wq``,
``decoder.ln_cross``, ``decoder.cross.wk``, ``enc_norm``, ...): the
encoder is a dense :class:`~repro_torch.models.transformer.DecoderParams`
stack, and :class:`CrossDecoderParams` adds ``ln_cross`` and ``cross`` to
one.  The encoder's and the cross-attention's flash calls name their site
(``encoder``, ``cross_prefill``, ``cross_decode``), so the launch counters
tell them apart.  Training (:func:`encoder_apply` over the encoder's
per-layer trees and :func:`decoder_stack_train`) follows the reference's
``encoder_apply`` and ``decoder_stack_train``; its flash calls run the
differentiated wrapper, which counts them under ``flash_attention.train``
and ``flash_attention_bwd``, the encoder's and the cross-attention's
(site ``cross_prefill``: the decoder's rows over the whole memory) also
by site.

Over a serving mesh (``par``; the LM holds the rank's serving shard) the
encoder runs the explicit TP attention (flash non-causal at H / tp heads)
and SwiGLU; the cross K/V are the rank's KV heads where n_kv divides by
tp (the weights' rule), else whole, and they are the rank's ``cross_k`` /
``cross_v`` state; the cross-attention runs at the rank's query heads
over its KV block, then the row-parallel ``wo`` reduced over ``model``;
the decoder's self-attention runs as the dense stack's over a mesh
(striped pools, the cross-rank combine at decode).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    ParallelCtx,
    ckpt,
    empty_param,
    layer_remat,
)
from repro_torch.models.layers import head_proj, out_proj, rms_norm
from repro_torch.models.page_ops import PageCtx, prefill_write_op
from repro_torch.models.transformer import (
    AttnParams,
    DecoderParams,
    attn_block_decode,
    attn_block_train,
    ffn_block,
    kv_sharded,
    serving_attn_prefill,
    serving_geometry,
)


class CrossDecoderParams(DecoderParams):
    """The dense decoder stack (ln1, attn, ln2, mlp) over ``dec_layers``
    with each layer's cross-attention: ``ln_cross`` [Ld, d] and ``cross``
    (the attention weights' shapes)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        L = cfg.encdec.dec_layers
        super().__init__(cfg, L, dtype, device)
        self.ln_cross = empty_param((L, cfg.d_model), dtype, device)
        self.cross = AttnParams(cfg, L, dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        super().init_(gen)
        self.ln_cross.data.fill_(1.0)
        self.cross.init_(gen)

    def layer(self, l: int) -> Dict[str, object]:
        out = super().layer(l)
        out["ln_cross"] = self.ln_cross[l]
        out["cross"] = {n: p[l] for n, p in self.cross.named_parameters()}
        return out


def encoder_apply(cfg: ModelConfig, layers, enc_norm, src, *,
                  remat=False, par=None):
    """src [B, S, d] frame embeddings (projected) -> memory [B, S, d].

    ``layers``: the encoder's per-layer weight trees (serving:
    :meth:`DecoderParams.layer` of each layer; training:
    :meth:`DecoderParams.train_layers`), each layer recomputed in the
    backward unless ``remat`` is False or "none".  The flash calls count
    under the ``encoder`` site.  ``par``: a training forward's or a
    serving mesh's ranks (the attention and SwiGLU run as explicit blocks
    under megatron over a ``model`` axis, as the reference's)."""
    B, S, _ = src.shape
    positions = torch.arange(S, device=src.device)[None].expand(B, S)

    def layer(lp, x):
        x = x + attn_block_train(cfg, lp["attn"],
                                 rms_norm(x, lp["ln1"], cfg.norm_eps),
                                 positions, causal=False, site="encoder",
                                 par=par)[0]
        return x + ffn_block(cfg, lp["mlp"],
                             rms_norm(x, lp["ln2"], cfg.norm_eps), par)

    x = src
    on = layer_remat(remat)
    for lp in layers:
        x = ckpt(layer, lp, x) if on else layer(lp, x)
    return rms_norm(x, enc_norm, cfg.norm_eps)


def cross_kv(cp, memory):
    """One layer's cross K/V from the encoder memory: [B, S, n_kv, dh]
    each (no bias, no RoPE, as the reference)."""
    return head_proj(memory, cp["wk"]), head_proj(memory, cp["wv"])


def _reduce_cross(par: ParallelCtx, y):
    """The cross-attention's partial outputs summed over ``model``
    (chip_smoke.py's ``cross`` fault replaces it by the rank's own)."""
    return par.reduce_from_model(y)


def cross_attend(cp, h, ck, cv, site="cross_prefill", *,
                 cfg: Optional[ModelConfig] = None,
                 par: Optional[ParallelCtx] = None):
    """h [B, T, d] queries against one layer's cross K/V, non-causal.
    ``par``: a serving mesh, ``cp`` the rank's query heads (``par``'s
    geometry of ``cfg``), which attend to the rank's KV block (``ck`` /
    ``cv`` the rank's KV heads, or whole ones sliced) before the
    row-parallel ``wo`` is reduced over ``model``.  None: whole weights
    (one device; training, which gathers the cross weights as the
    reference's GSPMD)."""
    q = head_proj(h, cp["wq"])
    geo = serving_geometry(cfg, par) if par is not None else None
    if geo is not None and not kv_sharded(cfg, geo):
        lo, nkv = geo[3][par.model_rank], geo[2]
        ck = ck[:, :, lo:lo + nkv].contiguous()
        cv = cv[:, :, lo:lo + nkv].contiguous()
    y = out_proj(flash_attention(q, ck, cv, causal=False, site=site),
                 cp["wo"])
    return y if geo is None else _reduce_cross(par, y)


def _cross_ffn(cfg: ModelConfig, lp, x, ck, cv, site, par=None,
               cross_par=None):
    """The layer's cross-attention and FFN, each with its residual (the
    cross-attention under ``cross_par`` as :func:`cross_attend`'s; the FFN
    under ``par`` as :func:`ffn_block`'s)."""
    x = x + cross_attend(lp["cross"],
                         rms_norm(x, lp["ln_cross"], cfg.norm_eps), ck, cv,
                         site, cfg=cfg, par=cross_par)
    return x + ffn_block(cfg, lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                         par)


def decoder_stack_prefill(cfg: ModelConfig, params: CrossDecoderParams, x,
                          positions, memory, pools, ctx: PageCtx,
                          par: Optional[ParallelCtx] = None):
    """Writes each layer's self-attention K/V into its pool slice in place.
    Returns (x, pools, (cross_k, cross_v) [L, B, S, n_kv, dh]).  ``par``:
    a serving mesh (module docstring; this rank's stripe of the pools, its
    KV heads of the cross K/V)."""
    k_pools, v_pools = pools
    cks, cvs = [], []
    for l in range(params.n_layers):
        lp = params.layer(l)
        a, k, v = serving_attn_prefill(cfg, lp["attn"],
                                       rms_norm(x, lp["ln1"], cfg.norm_eps),
                                       positions, par)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx, par=par)
        ck, cv = cross_kv(lp["cross"], memory)
        x = _cross_ffn(cfg, lp, x + a, ck, cv, "cross_prefill", par, par)
        cks.append(ck)
        cvs.append(cv)
    return x, pools, (torch.stack(cks), torch.stack(cvs))


def decoder_stack_train(cfg: ModelConfig, layers, x, positions, memory, *,
                        remat=True, par=None):
    """The decoder's training forward over its per-layer trees
    (:meth:`CrossDecoderParams.train_layers`): causal self-attention,
    cross-attention to ``memory`` [B, S, d] (non-causal, all S rows), then
    SwiGLU; each layer recomputed in the backward unless ``remat`` is
    False or "none".  The cross-attention counts under the
    ``cross_prefill`` site, the self-attention under none.  ``par`` as
    :func:`encoder_apply`'s."""

    def layer(lp, x, memory):
        a = attn_block_train(cfg, lp["attn"],
                             rms_norm(x, lp["ln1"], cfg.norm_eps),
                             positions, par=par)[0]
        ck, cv = cross_kv(lp["cross"], memory)
        return _cross_ffn(cfg, lp, x + a, ck, cv, "cross_prefill", par)

    on = layer_remat(remat)
    for lp in layers:
        x = ckpt(layer, lp, x, memory) if on else layer(lp, x, memory)
    return x


def decoder_stack_decode(cfg: ModelConfig, params: CrossDecoderParams, x,
                         pos, pools, ctx: PageCtx, cross,
                         par: Optional[ParallelCtx] = None):
    """x [B, 1, d]; ``cross`` = (cross_k, cross_v) [L, B, S, n_kv, dh].
    Writes this token's K/V into the pools in place; ``par`` as
    :func:`decoder_stack_prefill`'s."""
    k_pools, v_pools = pools
    cks, cvs = cross
    for l in range(params.n_layers):
        lp = params.layer(l)
        # Staged pages arrive layer-stacked; each layer reads its slice.
        x = x + attn_block_decode(cfg, lp["attn"],
                                  rms_norm(x, lp["ln1"], cfg.norm_eps), pos,
                                  k_pools[l], v_pools[l], ctx.stage_at(l),
                                  par)
        x = _cross_ffn(cfg, lp, x, cks[l], cvs[l], "cross_decode", par,
                       par)
    return x, pools
