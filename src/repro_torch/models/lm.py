"""Language-model facade: weights, pool shapes, prefill and decode.

Counterpart of the reference's ``models/lm.py`` for the dense family.  The
reference casts its fp32 parameter tree to ``cfg.dtype`` on every call; the
port stores every weight once in ``cfg.dtype``.  Parameter names follow the
reference's tree (``embed``, ``final_norm``, ``decoder.attn.wq``, ...), so
:func:`repro_torch.bridge.params_from_jax` maps one onto the other.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import embed_init_
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (
    DecoderParams,
    PageCtx,
    decoder_stack_decode,
    decoder_stack_prefill,
)


class LM(nn.Module):
    """Dense decoder LM.  Weights are allocated uninitialised on ``device``;
    fill them with :meth:`init_weights` or ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, *, device="cpu"):
        super().__init__()
        if cfg.family != "dense" or cfg.moe is not None \
                or cfg.mla is not None:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: the non-dense "
                f"families (moe, mla, ssm, hybrid, encdec, vlm) come in a "
                f"later slice")
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
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
        self.decoder = DecoderParams(cfg, cfg.n_layers, dtype, device)

    def init_weights(self, generator: torch.Generator) -> "LM":
        """Draw every weight from ``generator`` with the reference's
        distributions (its numbers differ: different generator)."""
        embed_init_(self.embed, generator)
        self.final_norm.data.fill_(1.0)
        if not self.cfg.tie_embeddings:
            embed_init_(self.unembed, generator)
        self.decoder.init_(generator)
        return self

    # ------------------------------------------------------------- pools

    def kv_layers(self) -> int:
        return self.cfg.n_layers

    def pool_shapes(self, num_pages: int, page_tokens: int,
                    dtype=torch.bfloat16
                    ) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """[(k_pool shape, dtype), (v_pool shape, dtype)]."""
        cfg = self.cfg
        shape = (self.kv_layers(), num_pages, page_tokens, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return [(shape, dtype), (shape, dtype)]

    # ------------------------------------------------------------- heads

    def _embed(self, tokens):
        return self.embed[tokens.long()]

    def _logits(self, x):
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        return x @ w

    # ------------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill(self, batch, pools, ctx: PageCtx,
                last_pos: Optional[torch.Tensor] = None):
        """Full-sequence forward; writes K/V into the paged pools in place.

        ``batch["tokens"]`` [B, T] (right-padded to a page multiple);
        ``last_pos`` [B]: index of the last valid token per sequence
        (defaults to T-1).  Returns (logits at last_pos [B, V], pools).
        """
        tokens = batch["tokens"]
        B, T = tokens.shape
        x = self._embed(tokens)
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
        x, pools = decoder_stack_prefill(self.cfg, self.decoder, x,
                                         positions, pools, ctx)
        if last_pos is None:
            x_last = x[:, -1:, :]
        else:
            x_last = x[torch.arange(B, device=x.device),
                       last_pos.long()][:, None, :]
        return self._logits(x_last)[:, 0], pools

    # ------------------------------------------------------------- decode

    @torch.no_grad()
    def decode_step(self, tokens, pos, pools, ctx: PageCtx):
        """tokens [B] int32, pos [B] current positions (0-based).

        Writes this step's K/V into the pools in place.  Returns
        (logits [B, V], pools).
        """
        x = self._embed(tokens[:, None])
        x, pools = decoder_stack_decode(self.cfg, self.decoder, x, pos,
                                        pools, ctx)
        return self._logits(x)[:, 0], pools
