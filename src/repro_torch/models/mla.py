"""Multi-head Latent Attention (DeepSeek-V2): prefill and absorbed decode.

Counterpart of the reference's ``models/mla.py``.  Prefill (and training,
:data:`mla_block_train`) up-projects the
latent ``c = RMSNorm(x · W_DKV)`` to per-head K_nope / V and runs the
expanded attention through the flash-attention kernel (key width
nope + rope = 192, value width 128 at deepseek-v2-lite).  The paged cache
stores only the latent and the shared RoPE key: the K pool holds
``[latent ‖ k_rope]`` (kv_lora + rope = 576 wide), the V pool the latent
(512 wide), one KV "head" per token.

Decode uses the absorbed form: q_nope is pushed through W_UK once, the
paged-attention kernel scores the 576-wide query against the K pool and
sums the V pool's latents (all query heads share the one latent head), and
the latent-space output is up-projected through W_UV and ``wo`` after the
combine, so no per-head K / V is ever materialised at decode.

Serving over a mesh (a :class:`~repro_torch.models.common.ParallelCtx`)
takes wq, W_UK, W_UV and ``wo`` at this rank's heads (split over
``model``, the serving rules) and the latent projections whole: prefill
attends over this rank's heads and reduces its output projection over
``model``; decode gathers the absorbed query of every head over ``model``,
runs the paged kernel over this rank's stripe of the latent pools for all
of them, combines across the page group and up-projects its own heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import ParallelCtx, dense_init_, empty_param
from repro_torch.models.layers import apply_rope, rms_norm, rope_angles
from repro_torch.models.page_ops import paged_attn_op


class MLAParams(nn.Module):
    """MLA weights stacked over layers (the reference's ``init_mla_params``):
    wq [L, d, H, nope + rope], w_dkv [L, d, kv_lora], w_kr [L, d, rope],
    kv_norm [L, kv_lora], w_uk [L, kv_lora, H, nope], w_uv [L, kv_lora, H,
    v], wo [L, H, v, d]."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        m = cfg.mla
        d, H, r = cfg.d_model, cfg.n_heads, m.kv_lora_rank
        qdim = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wq = empty_param((L, d, H, qdim), dtype, device)
        self.w_dkv = empty_param((L, d, r), dtype, device)
        self.w_kr = empty_param((L, d, m.qk_rope_head_dim), dtype, device)
        self.kv_norm = empty_param((L, r), dtype, device)
        self.w_uk = empty_param((L, r, H, m.qk_nope_head_dim), dtype, device)
        self.w_uv = empty_param((L, r, H, m.v_head_dim), dtype, device)
        self.wo = empty_param((L, H, m.v_head_dim, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("wq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo"):
            dense_init_(getattr(self, name), 1, gen)
        self.kv_norm.data.fill_(1.0)


def _proj(x, w):
    """x [B, T, d] times w [d, *out] -> [B, T, *out]."""
    B, T, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, T, *w.shape[1:])


def _q_and_latent(cfg: ModelConfig, p, x, positions):
    """Shared projections: roped q halves, normalised latent, roped k_rope."""
    m = cfg.mla
    q = _proj(x, p["wq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos[..., :, None, :], sin[..., :, None, :])
    lat = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], cos[..., :, None, :],
                        sin[..., :, None, :])[:, :, 0, :]
    return q_nope, q_rope, lat, k_rope


def _heads_split(cfg: ModelConfig, p) -> bool:
    """Whether ``p`` holds this rank's heads of the query-side weights."""
    return p["wq"].shape[-2] < cfg.n_heads


def _reduce(cfg: ModelConfig, p, par: Optional[ParallelCtx], y):
    """A head-split block's partial output summed over ``model``."""
    if par is not None and _heads_split(cfg, p):
        return par.reduce_from_model(y)
    return y


def mla_block_prefill(cfg: ModelConfig, p, x, positions,
                      par: Optional[ParallelCtx] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expanded causal attention (the reference's ``mla_block_train``):
    x [B, T, d] -> (out [B, T, d], {"k": [B, T, 1, kv_lora + rope],
    "v": [B, T, 1, kv_lora]}, the paged-cache payloads).  With ``par`` and
    the heads split, over this rank's heads, the output reduced over
    ``model``."""
    m = cfg.mla
    q_nope, q_rope, lat, k_rope = _q_and_latent(cfg, p, x, positions)
    B, T, H = q_nope.shape[:3]
    k_nope = _proj(lat, p["w_uk"])
    v = _proj(lat, p["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, v, causal=True,
                        scale=(m.qk_nope_head_dim
                               + m.qk_rope_head_dim) ** -0.5)
    wo = p["wo"]
    out = o.reshape(B, T, -1) @ wo.reshape(-1, wo.shape[-1])
    payload = {"k": torch.cat([lat, k_rope], dim=-1)[:, :, None, :],
               "v": lat[:, :, None, :]}
    return _reduce(cfg, p, par, out), payload


# The reference's ``mla_block_train``: under grad mode the flash call runs
# the kernel's autograd function at key width nope + rope (192) and value
# width v (128), and k_rope's gradient sums over the H heads its expand fed.
mla_block_train = mla_block_prefill


def mla_block_decode(cfg: ModelConfig, p, x, pos, k_pool, v_pool, ctx,
                     par: Optional[ParallelCtx] = None):
    """Absorbed-form decode over the latent paged pools (written in place).

    x [B, 1, d], pos [B]; pools k [NP, ptok, 1, kv_lora + rope], v [NP,
    ptok, 1, kv_lora] (with ``par``'s page shards this rank's stripe).
    Returns [B, 1, d]."""
    m = cfg.mla
    q_nope, q_rope, lat, k_rope = _q_and_latent(cfg, p, x, pos[:, None])
    # Absorb W_UK into the query: scores against the latent directly.
    q_lat = torch.einsum("bhn,khn->bhk", q_nope[:, 0], p["w_uk"])
    q_eff = torch.cat([q_lat, q_rope[:, 0]], dim=-1)    # [B, H, lora + rope]
    split = par is not None and _heads_split(cfg, p)
    if split:
        q_eff = par.gather_model(q_eff, 1)
    k_new = torch.cat([lat, k_rope], dim=-1)[:, 0, None, :]
    v_new = lat[:, 0, None, :]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o_lat = paged_attn_op(q_eff, k_new, v_new, k_pool, v_pool, ctx,
                          scale=scale, par=par)
    if split:
        H_loc = p["wq"].shape[-2]
        o_lat = o_lat[:, par.model_rank * H_loc:(par.model_rank + 1) * H_loc]
    o = torch.einsum("bhk,khv->bhv", o_lat.to(x.dtype), p["w_uv"])
    wo = p["wo"]
    y = o.reshape(o.shape[0], -1) @ wo.reshape(-1, wo.shape[-1])
    return _reduce(cfg, p, par, y)[:, None, :]
