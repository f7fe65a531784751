"""Dense decoder-only transformer stack (mesh-free).

Counterpart of the dense, ``mesh is None`` paths of the reference's
``models/transformer.py``.  Weights stay stacked over a leading layer axis in
the reference's shapes (``wq [L, d, H, dh]``, ``wo [L, H, dh, d]``, ...); the
reference's ``lax.scan`` over layers is a Python loop over layer slices.

  * prefill: full-sequence causal blockwise attention, plus an en-masse
    scatter of each layer's K/V into its pool slice;
  * decode: one token per sequence, written into the paged pool and
    attended through the paged decode-attention kernel (plain version on
    CPU tensors).

Pools are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.models import paged
from repro_torch.models.common import dense_init_
from repro_torch.models.layers import (
    apply_rope,
    attention,
    gqa_qkv,
    rms_norm,
    rope_angles,
    swiglu,
)


# ------------------------------------------------------------------ page ctx


@dataclasses.dataclass
class PageCtx:
    """Device-side paged-KV addressing for one engine step.

    tables/ntok: [B, S, mpps]; wpage: [B, S]; wslot: [B] (int32 tensors).
    """

    tables: torch.Tensor
    ntok: torch.Tensor
    wpage: torch.Tensor
    wslot: torch.Tensor
    frame_pages: int = 16       # frame striping granularity (prefill scatter)


# ------------------------------------------------------------------ params


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class AttnParams(nn.Module):
    """Stacked attention weights: wq [L,d,H,dh], wk/wv [L,d,Hkv,dh],
    wo [L,H,dh,d], and with ``qkv_bias`` bq [L,H,dh], bk/bv [L,Hkv,dh]."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        if cfg.qk_norm:
            raise NotImplementedError(
                "qk_norm configs are not ported yet (later slice)")
        d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        self.wq = _param((L, d, H, dh), dtype, device)
        self.wk = _param((L, d, Hkv, dh), dtype, device)
        self.wv = _param((L, d, Hkv, dh), dtype, device)
        self.wo = _param((L, H, dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((L, H, dh), dtype, device)
            self.bk = _param((L, Hkv, dh), dtype, device)
            self.bv = _param((L, Hkv, dh), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            dense_init_(getattr(self, name), 1, gen)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).data.zero_()


class FFNParams(nn.Module):
    """Stacked SwiGLU weights: w_gate/w_up [L,d,f], w_down [L,f,d]."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((L, d, f), dtype, device)
        self.w_up = _param((L, d, f), dtype, device)
        self.w_down = _param((L, f, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            dense_init_(getattr(self, name), 1, gen)


class DecoderParams(nn.Module):
    """Stacked decoder-layer weights (the reference's ``init_decoder_params``)."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        self.ln1 = _param((L, cfg.d_model), dtype, device)
        self.ln2 = _param((L, cfg.d_model), dtype, device)
        self.attn = AttnParams(cfg, L, dtype, device)
        self.mlp = FFNParams(cfg, L, dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln1.data.fill_(1.0)
        self.ln2.data.fill_(1.0)
        self.attn.init_(gen)
        self.mlp.init_(gen)

    def layer(self, l: int) -> Dict[str, object]:
        """Layer ``l``'s weight slices as the reference's per-layer tree."""
        return {
            "ln1": self.ln1[l], "ln2": self.ln2[l],
            "attn": {n: p[l] for n, p in self.attn.named_parameters()},
            "mlp": {n: p[l] for n, p in self.mlp.named_parameters()},
        }

    @property
    def n_layers(self) -> int:
        return self.ln1.shape[0]


# ------------------------------------------------------------------ attention


def _project_qkv(cfg: ModelConfig, p, x, positions):
    """x [B,T,d] -> roped q [B,T,H,dh], k/v [B,T,Hkv,dh]."""
    q, k, v = gqa_qkv(x, p["wq"], p["wk"], p["wv"],
                      p.get("bq"), p.get("bk"), p.get("bv"))
    cos, sin = rope_angles(positions, q.shape[-1], cfg.rope_theta)
    q = apply_rope(q, cos[..., :, None, :], sin[..., :, None, :])
    k = apply_rope(k, cos[..., :, None, :], sin[..., :, None, :])
    return q, k, v


def attn_block_train(cfg: ModelConfig, p, x, positions, *, causal=True,
                     kv_len=None):
    """Full-sequence attention.  Returns (out [B,T,d], k, v)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = attention(q, k, v, causal=causal, kv_len=kv_len)
    B, T = o.shape[:2]
    y = o.reshape(B, T, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return y, k, v


def paged_attn_op(q, k_new, v_new, k_pool, v_pool, ctx: PageCtx, *, scale):
    """Decode pool write + paged attention (pools updated in place).

    q [B,H,dh]; k_new/v_new [B,n_kv,dh]; pools [NP, ptok, n_kv, dh].
    Returns o [B,H,dh] in q's dtype.
    """
    B = q.shape[0]
    tables = ctx.tables.reshape(B, -1)
    ntok = ctx.ntok.reshape(B, -1)
    # One shard column holds the write page; the rest are -1.
    wpage = ctx.wpage.reshape(B, -1).amax(dim=1)
    paged.write_kv(k_pool, v_pool, k_new, v_new, wpage, ctx.wslot)
    o, m, l = paged_attention_kernel(q, k_pool, v_pool, tables, ntok,
                                     granularity="page", scale=scale)
    return paged.combine_partials(o, m, l).to(q.dtype)


def prefill_write_op(k_seq, v_seq, k_pool, v_pool, ctx: PageCtx,
                     tok_offset: int = 0):
    """Scatter prefilled K/V [B,T,n_kv,dh] into the paged pool, in place."""
    tables = ctx.tables.reshape(ctx.tables.shape[0], -1)
    return paged.write_prefill_kv(k_pool, v_pool, k_seq, v_seq, tables,
                                  frame_pages=ctx.frame_pages,
                                  tok_offset=tok_offset)


def attn_block_decode(cfg: ModelConfig, p, x, pos, k_pool, v_pool,
                      ctx: PageCtx):
    """x [B,1,d], pos [B] -> [B,1,d]; writes this token's K/V in place."""
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    dh = cfg.resolved_head_dim
    o = paged_attn_op(q[:, 0], k[:, 0], v[:, 0], k_pool, v_pool, ctx,
                      scale=dh ** -0.5)
    B = o.shape[0]
    y = o.reshape(B, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return y[:, None, :]


def ffn_block(cfg: ModelConfig, p, x):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ------------------------------------------------------------------ stack


def decoder_stack_prefill(cfg: ModelConfig, params: DecoderParams, x,
                          positions, pools, ctx: PageCtx):
    """pools: (k_pool [L,...], v_pool [L,...]), written in place."""
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, k, v = attn_block_train(cfg, lp["attn"], h, positions)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_block(cfg, lp["mlp"], h)
    return x, pools


def decoder_stack_decode(cfg: ModelConfig, params: DecoderParams, x, pos,
                         pools, ctx: PageCtx):
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn_block_decode(cfg, lp["attn"], h, pos, k_pools[l],
                                  v_pools[l], ctx)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_block(cfg, lp["mlp"], h)
    return x, pools
