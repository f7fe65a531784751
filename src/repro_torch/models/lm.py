"""Language-model facade: weights, pool shapes, prefill and decode.

Counterpart of the reference's ``models/lm.py`` for all six families:

  dense   -> transformer stack, paged KV pools [L, NP, ...]
  vlm     -> the dense stack over the projected patch embeddings
             (``frontend_proj``) followed by the prompt's tokens
  moe     -> transformer stack with routed-expert FFNs after
             ``moe.first_dense`` dense-FFN layers (``decoder_prefix``); with
             ``cfg.mla`` its attention is MLA and the pools hold latents
             (K [L, NP, ptok, 1, kv_lora + rope], V [..., kv_lora])
  ssm     -> Mamba-2 stack: recurrent state, no KV pool
  hybrid  -> Mamba-2 backbone + a shared attention block whose KV is
             paged with one pool slice per invocation [G, NP, ...]
  encdec  -> an encoder over the projected source frames; a decoder with
             paged self-attention [Ld, NP, ...] and cross-attention to the
             encoder memory, whose K/V is dense decode state

The reference casts its fp32 parameter tree to ``cfg.dtype`` on every call;
the port's serving LM stores every weight once in ``cfg.dtype``.  For
training, ``LM(cfg, master=True)`` holds them as fp32 master weights with
gradients enabled, and :meth:`LM.loss` casts them to ``cfg.dtype`` at its
entry, as the reference's loss does (every family).  Parameter names follow
the reference's tree (``embed``, ``final_norm``, ``decoder.attn.wq``,
``decoder_prefix.mlp.w_up``, ``decoder.moe.router``, ``decoder.mamba.w_in``,
...), so :func:`repro_torch.bridge.params_from_jax` maps one onto the other.
``prefill`` and ``decode_step`` return and take the reference's non-pool
decode state (``{"ssm", "conv"}`` for the recurrent families, ``{"cross_k",
"cross_v"}`` for encdec, ``{}`` for the other transformer families).

Both serve over a mesh of ranks when given a serving
:class:`~repro_torch.models.common.ParallelCtx` (``serving_ctx``), every
family: the LM then holds this rank's serving shard of every weight
(``launch/sharding.py::serving_lm``), its stripe of the pools and its
decode state (its rows; the recurrent families' heads and conv channels,
encdec's KV heads of the cross K/V where they divide); every rank passes
the global batch (vlm's ``patch_embeds`` and encdec's ``src_embeds``
included) and context and computes its own rows (all of them when the
batch is not split); the embedding and the logits are split over
``model`` by vocabulary (a masked lookup summed over ``model``; the
logits gathered).  ``frontend_proj`` stays whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import hybrid as hy
from repro_torch.models import mamba2 as m2
from repro_torch.models.common import (
    ParallelCtx,
    embed_init_,
    on_mesh,
    train_weight,
)
from repro_torch.models.layers import rms_norm
from repro_torch.models.page_ops import PageCtx
from repro_torch.models.transformer import (
    DecoderParams,
    decoder_stack_decode,
    decoder_stack_prefill,
    decoder_stack_train,
    ffn_tp,
    kv_sharded,
    tp_geometry,
)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
AUX_LOSS_COEF = 0.01


def _dense_view(cfg: ModelConfig) -> ModelConfig:
    """The config of a MoE model's leading dense-FFN layers."""
    return dataclasses.replace(cfg, moe=None)


def _first_dense(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe is not None else 0


class LM(nn.Module):
    """An LM of any family of :data:`FAMILIES`.  Weights are allocated
    uninitialised on ``device``; fill them with :meth:`init_weights` or
    ``load_state_dict``.  ``master=True`` allocates them in float32 with
    ``requires_grad`` set: the fp32 master weights that :meth:`loss`
    differentiates and the optimizer updates."""

    def __init__(self, cfg: ModelConfig, *, device="cpu",
                 master: bool = False):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        dtype = torch.float32 if master else getattr(torch, cfg.dtype)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(
            torch.empty((V, d), dtype=dtype, device=device),
            requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.empty((d,), dtype=dtype, device=device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty((d, V), dtype=dtype, device=device),
                requires_grad=False)
        if cfg.family in ("vlm", "encdec"):
            self.frontend_proj = nn.Parameter(
                torch.empty((d, d), dtype=dtype, device=device),
                requires_grad=False)
        if cfg.family == "encdec":
            self.encoder = DecoderParams(cfg, cfg.encdec.enc_layers, dtype,
                                         device)
            self.decoder = ed.CrossDecoderParams(cfg, dtype, device)
            self.enc_norm = nn.Parameter(
                torch.empty((d,), dtype=dtype, device=device),
                requires_grad=False)
        elif cfg.family == "ssm":
            self.decoder = m2.SSMStackParams(cfg, cfg.n_layers, dtype,
                                             device)
        elif cfg.family == "hybrid":
            self.decoder = hy.HybridParams(cfg, dtype, device)
        else:
            fd = _first_dense(cfg)
            if fd:
                self.decoder_prefix = DecoderParams(_dense_view(cfg), fd,
                                                    dtype, device)
            self.decoder = DecoderParams(cfg, cfg.n_layers - fd, dtype,
                                         device)
        if master:
            for p in self.parameters():
                p.requires_grad_(True)

    def init_weights(self, generator: torch.Generator) -> "LM":
        """Draw every weight from ``generator`` with the reference's
        distributions (its numbers differ: different generator)."""
        embed_init_(self.embed, generator)
        self.final_norm.data.fill_(1.0)
        if not self.cfg.tie_embeddings:
            embed_init_(self.unembed, generator)
        if hasattr(self, "frontend_proj"):
            embed_init_(self.frontend_proj, generator)
        if hasattr(self, "encoder"):
            self.encoder.init_(generator)
            self.enc_norm.data.fill_(1.0)
        if hasattr(self, "decoder_prefix"):
            self.decoder_prefix.init_(generator)
        self.decoder.init_(generator)
        return self

    def model_local(self, name: str, par: ParallelCtx) -> bool:
        """Whether the parameter ``name`` enters an explicit block of
        ``par`` at its model shard (the reference's ``shard_map`` in_specs
        that split it over ``model``); a ``model``-split leaf that does not
        is gathered over ``model`` where it is cast (the layout's rule 3).
        The explicit blocks: the GQA attention under a
        :func:`~repro_torch.models.transformer.tp_geometry` (wq, wo, bq;
        wk, wv, bk, bv when kv-sharded) in the decoder, the encoder and the
        hybrid's shared block, the SwiGLU whose d_ff divides tp, and the
        MoE block (experts and shared experts).  MLA, encdec's
        cross-attention, Mamba-2 and the embeddings have none."""
        if not par.explicit:
            return False
        keys = name.split(".")
        leaf, cfg = keys[-1], self.cfg
        if "moe" in keys:
            return leaf in ("w_gate", "w_up", "w_down", "ws_gate", "ws_up",
                            "ws_down")
        if "mlp" in keys:
            return ffn_tp(cfg, par)
        if "attn" in keys and cfg.mla is None:
            geo = tp_geometry(cfg, par.tp)
            if geo is None:
                return False
            if leaf in ("wq", "wo", "bq"):
                return True
            return leaf in ("wk", "wv", "bk", "bv") and kv_sharded(cfg, geo)
        return False

    # ------------------------------------------------------------- pools

    def kv_layers(self) -> int:
        """Pool slices: one per layer (dense), one per shared-block
        invocation (hybrid), one per decoder layer (encdec), none (ssm)."""
        if self.cfg.family == "ssm":
            return 0
        if self.cfg.family == "hybrid":
            return hy.n_invocations(self.cfg)
        if self.cfg.family == "encdec":
            return self.cfg.encdec.dec_layers
        return self.cfg.n_layers

    def pool_shapes(self, num_pages: int, page_tokens: int,
                    dtype=torch.bfloat16
                    ) -> Optional[List[Tuple[Tuple[int, ...], torch.dtype]]]:
        """[(k_pool shape, dtype), (v_pool shape, dtype)], or None for the
        attention-free ssm family; MLA pools hold the latent payloads."""
        cfg = self.cfg
        L = self.kv_layers()
        if L == 0:
            return None
        if cfg.mla is not None:
            m = cfg.mla
            k = (L, num_pages, page_tokens, 1,
                 m.kv_lora_rank + m.qk_rope_head_dim)
            v = (L, num_pages, page_tokens, 1, m.kv_lora_rank)
            return [(k, dtype), (v, dtype)]
        shape = (L, num_pages, page_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return [(shape, dtype), (shape, dtype)]

    def init_state_shapes(self, batch: int, src_len: int = 0
                          ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Non-pool decode state as {name: (shape, dtype)}: the recurrent
        families' ``ssm`` [L, B, nh, hd, N] (f32) and ``conv``
        [L, B, d_conv-1, conv_dim], encdec's ``cross_k`` / ``cross_v``
        [Ld, B, src_len, n_kv, dh] (``cfg.dtype``); empty for the other
        families.  The heads, conv channels and KV heads are those of the
        weights this LM holds: a serving rank's shard gives the rank's."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        if cfg.family == "encdec":
            shape = (cfg.encdec.dec_layers, batch, src_len,
                     self.decoder.cross.wk.shape[-2], cfg.resolved_head_dim)
            return {"cross_k": (shape, dtype), "cross_v": (shape, dtype)}
        if cfg.family not in ("ssm", "hybrid"):
            return {}
        mp = self.decoder.mamba
        s_shape, c_shape = m2.state_shapes(cfg, cfg.n_layers, batch,
                                           mp.A_log.shape[-1],
                                           mp.conv_b.shape[-1])
        return {"ssm": (s_shape, torch.float32), "conv": (c_shape, dtype)}

    # ------------------------------------------------------------- heads

    def _embed(self, tokens, par: Optional[ParallelCtx] = None):
        V_loc = self.embed.shape[0]
        if par is None or V_loc == self.cfg.vocab_size:
            return self.embed[tokens.long()]
        t = tokens.long() - par.model_rank * V_loc
        inside = (t >= 0) & (t < V_loc)
        x = self.embed[t.clamp(0, V_loc - 1)] * inside[..., None].to(
            self.embed.dtype)
        return par.reduce_from_model(x)

    def _frontend(self, embeds, like):
        """Frontend embeddings [B, P, d] projected into the model:
        ``embeds @ frontend_proj`` in ``like``'s dtype."""
        return embeds.to(device=like.device, dtype=like.dtype) \
            @ self.frontend_proj

    def _frontend_train(self, embeds, dtype):
        """The training forward's frontend: ``embeds @ frontend_proj``, both
        in ``dtype``, ``frontend_proj`` differentiated."""
        e = torch.as_tensor(embeds).to(self.embed.device, dtype)
        return e @ train_weight(self.frontend_proj, dtype)

    def _logits(self, x, par: Optional[ParallelCtx] = None):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        logits = x @ w
        if par is not None and w.shape[1] < self.cfg.vocab_size:
            logits = par.gather_model(logits, -1)
        return logits

    def _serving_par(self, par: Optional[ParallelCtx]
                     ) -> Optional[ParallelCtx]:
        """``par`` if it spans more than one rank (else None: the
        one-device path).  Raises where its ``model`` axis cannot split
        the Mamba-2 blocks by heads (``mamba2.heads_split``)."""
        if not on_mesh(par):
            return None
        if self.cfg.ssm is not None:
            m2.heads_split(self.cfg, par.tp)
        return par

    # ------------------------------------------------------------- train

    def loss(self, batch, *, remat=True, par: Optional[ParallelCtx] = None):
        """The reference's training loss on ``batch["tokens"]`` [B, T] (vlm
        also takes ``batch["patch_embeds"]`` [B, P, d], encdec
        ``batch["src_embeds"]`` [B, S, d]): the weights cast to
        ``cfg.dtype``, the family's training stack (``remat`` as
        :func:`decoder_stack_train`'s; the hybrid stack recomputes nothing,
        as the reference), logits through the tied ``embed`` or
        ``unembed`` for the token positions only, and the masked mean NLL of
        each next token over ``log_softmax`` in f32.  Returns (total,
        {"nll", "aux", "tokens"}); differentiate ``total`` = nll +
        :data:`AUX_LOSS_COEF` x aux, where aux sums the MoE layers'
        load-balance losses (0 without MoE).  A MoE model's dense-FFN
        layers (``decoder_prefix``) run first, as the reference's.

        Over ranks each passes its rows of the batch and its
        :class:`~repro_torch.models.common.ParallelCtx`: the MoE
        load-balance loss then takes its expert loads over every data
        rank's rows (:func:`moe_block`), so that the ranks' mean loss and
        gradient are the whole batch's, and under megatron with a ``model``
        axis > 1 the attention, SwiGLU and MoE blocks run on this rank's
        model shards (the reference's explicit blocks).  Weights the trainer
        holds as shards but the forward needs whole (FSDP's; a
        ``model``-split leaf outside those blocks) are gathered where they
        are cast (:func:`train_weight`); the logits and the loss are then
        computed whole on every model rank."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        dev = self.embed.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev, torch.long)
        B, T = tokens.shape
        embed = train_weight(self.embed, dtype)
        x = F.embedding(tokens, embed)
        n_prefix = 0
        if cfg.family == "vlm":
            pe = self._frontend_train(batch["patch_embeds"], dtype)
            x = torch.cat([pe, x], dim=1)
            n_prefix = pe.shape[1]
        positions = torch.arange(x.shape[1], device=dev)[None].expand(
            B, x.shape[1])
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.family == "encdec":
            memory = ed.encoder_apply(
                cfg, self.encoder.train_layers(dtype),
                train_weight(self.enc_norm, dtype),
                self._frontend_train(batch["src_embeds"], dtype), remat=remat,
                par=par)
            x = ed.decoder_stack_train(cfg, self.decoder.train_layers(dtype),
                                       x, positions, memory, remat=remat,
                                       par=par)
        elif cfg.family == "ssm":
            x = m2.ssm_stack_train(cfg, self.decoder.train_layers(dtype), x,
                                   remat=remat)
        elif cfg.family == "hybrid":
            x = hy.hybrid_stack_train(cfg, self.decoder.train_tree(dtype), x,
                                      positions, par=par)
        else:
            if hasattr(self, "decoder_prefix"):
                x, a0 = decoder_stack_train(
                    _dense_view(cfg), self.decoder_prefix.train_layers(dtype),
                    x, positions, remat=remat, par=par)
                aux = aux + a0
            x, a1 = decoder_stack_train(cfg, self.decoder.train_layers(dtype),
                                        x, positions, remat=remat, par=par)
            aux = aux + a1
        x = x[:, n_prefix:]
        x = rms_norm(x, train_weight(self.final_norm, dtype), cfg.norm_eps)
        w = embed.T if cfg.tie_embeddings else train_weight(self.unembed,
                                                             dtype)
        logits = (x @ w).float()
        tgt = tokens[:, 1:]
        lp = F.log_softmax(logits[:, :-1], dim=-1)
        # nll_loss gathers the targets with a deterministic backward on
        # CUDA (no atomics), unlike torch.gather.
        nll = F.nll_loss(lp.reshape(-1, lp.shape[-1]),
                         tgt.clamp(min=0).reshape(-1),
                         reduction="none").view(B, T - 1)
        mask = (tgt >= 0).float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = loss + AUX_LOSS_COEF * aux
        return total, {"nll": loss, "aux": aux, "tokens": mask.sum()}

    # ------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, batch, pools, ctx: PageCtx,
                last_pos: Optional[torch.Tensor] = None, prefix_kv=None,
                prefix_len: int = 0, par: Optional[ParallelCtx] = None):
        """Full-sequence forward; writes K/V into the paged pools in place.

        ``batch["tokens"]`` [B, T] (right-padded to a page multiple);
        ``last_pos`` [B]: index of the last valid token per sequence
        (defaults to T-1).  vlm also takes ``batch["patch_embeds"]`` [B, P,
        d], projected and run in front of the tokens (positions 0 .. P + T
        - 1, the pools hold P + T tokens, ``last_pos`` stays an index into
        the tokens); encdec takes ``batch["src_embeds"]`` [B, S, d], the
        encoder's input.  Returns (logits at last_pos [B, V], pools,
        state): ``state`` is the recurrent families' ``{"ssm", "conv"}``
        after all T tokens (page padding included, as the reference),
        encdec's ``{"cross_k", "cross_v"}``, ``{}`` for the others.

        Suffix-only prefill (prefix-cache reuse): with ``prefix_kv=(k [L, B,
        P, Hkv, dh], v [...])`` and ``prefix_len=P`` (a page multiple),
        ``tokens`` holds only the suffix: positions start at P, queries
        attend to the cached prefix K/V, and only the suffix pages are
        written to the pools.  ``last_pos`` stays an index into the suffix.

        ``par``: a serving mesh (module docstring): ``batch``, ``ctx`` and
        ``last_pos`` are global, ``pools`` this rank's, and the logits and
        the state those of this rank's rows.
        """
        par = self._serving_par(par)
        tokens = batch["tokens"]
        rows = (lambda t: t) if par is None else par.rows
        if par is not None:
            tokens, ctx = rows(tokens), ctx.rows(par)
            last_pos = None if last_pos is None else rows(last_pos)
        B, T = tokens.shape
        if prefix_len:
            if prefix_kv is None:
                raise ValueError(f"prefix_len={prefix_len} without "
                                 f"prefix_kv")
            # Dense only, as the reference: recurrent state cannot start
            # from cached KV, and MoE capacity depends on the forward's
            # token count, so a suffix pass would not be bitwise.
            if self.cfg.family != "dense" or self.cfg.mla is not None:
                raise NotImplementedError(
                    f"prefix-cache reuse unsupported for {self.cfg.family} "
                    f"/ mla")
        x = self._embed(tokens, par)
        if self.cfg.family == "vlm":
            x = torch.cat([self._frontend(rows(batch["patch_embeds"]), x),
                           x], dim=1)
        n_prefix, Tx = x.shape[1] - T, x.shape[1]
        positions = (prefix_len + torch.arange(Tx, device=x.device))[
            None].expand(B, Tx)
        state: Dict[str, torch.Tensor] = {}
        if self.cfg.family == "encdec":
            memory = ed.encoder_apply(
                self.cfg, map(self.encoder.layer,
                              range(self.encoder.n_layers)), self.enc_norm,
                self._frontend(rows(batch["src_embeds"]), x), par=par)
            x, pools, (state["cross_k"], state["cross_v"]) = \
                ed.decoder_stack_prefill(self.cfg, self.decoder, x,
                                         positions, memory, pools, ctx, par)
        elif self.cfg.family == "ssm":
            x, state["ssm"], state["conv"] = m2.ssm_stack_prefill(
                self.cfg, self.decoder, x, par)
        elif self.cfg.family == "hybrid":
            x, pools, state["ssm"], state["conv"] = hy.hybrid_stack_prefill(
                self.cfg, self.decoder, x, positions, pools, ctx, par)
        else:
            x = self._stacks(decoder_stack_prefill, x, positions, pools, ctx,
                             par, prefix_kv=prefix_kv, tok_offset=prefix_len)
        if last_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = x[torch.arange(B, device=x.device),
                       n_prefix + last_pos.long()][:, None, :]
        return self._logits(x_last, par)[:, 0], pools, state

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def decode_step(self, tokens, pos, pools, ctx: PageCtx,
                    state: Optional[Dict[str, torch.Tensor]] = None,
                    par: Optional[ParallelCtx] = None):
        """tokens [B] int32, pos [B] current positions (0-based; vlm's count
        the patch positions); ``state`` the batch's stacked decode state
        (ssm/hybrid: recurrent; encdec: cross K/V).

        Writes this step's K/V into the pools in place.  Returns
        (logits [B, V], pools, state').  ``par``: a serving mesh, as
        :meth:`prefill`'s: ``tokens``, ``pos`` and ``ctx`` global,
        ``pools`` and ``state`` this rank's (as its prefill returned
        them), the logits those of its rows.
        """
        par = self._serving_par(par)
        if par is not None:
            tokens, pos, ctx = par.rows(tokens), par.rows(pos), ctx.rows(par)
        state = dict(state or {})
        x = self._embed(tokens[:, None], par)
        if self.cfg.family == "encdec":
            x, pools = ed.decoder_stack_decode(
                self.cfg, self.decoder, x, pos, pools, ctx,
                (state["cross_k"], state["cross_v"]), par)
        elif self.cfg.family == "ssm":
            x, state["ssm"], state["conv"] = m2.ssm_stack_decode(
                self.cfg, self.decoder, x, state["ssm"], state["conv"], par)
        elif self.cfg.family == "hybrid":
            x, pools, state["ssm"], state["conv"] = hy.hybrid_stack_decode(
                self.cfg, self.decoder, x, pos, pools, ctx, state["ssm"],
                state["conv"], par)
        else:
            x = self._stacks(decoder_stack_decode, x, pos, pools, ctx, par)
        return self._logits(x, par)[:, 0], pools, state

    def _stacks(self, stack, x, pos, pools, ctx: PageCtx,
                par: Optional[ParallelCtx] = None, **kw):
        """Run ``stack`` (prefill or decode) over the dense-FFN prefix layers
        (``decoder_prefix``, pool slices [:fd]) and then the decoder
        (slices [fd:]); the pools are written in place."""
        fd = _first_dense(self.cfg)
        if not fd:
            return stack(self.cfg, self.decoder, x, pos, pools, ctx, par=par,
                         **kw)[0]
        kp, vp = pools
        for cfg, params, sl in ((_dense_view(self.cfg), self.decoder_prefix,
                                 slice(None, fd)),
                                (self.cfg, self.decoder, slice(fd, None))):
            x = stack(cfg, params, x, pos, (kp[sl], vp[sl]),
                      ctx.stage_at(sl), par=par, **kw)[0]
        return x
