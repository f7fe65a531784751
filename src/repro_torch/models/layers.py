"""Core layers: norms, RoPE, blockwise (flash-style) attention, SwiGLU.

Counterpart of the reference's ``models/layers.py``.  :func:`attention`
keeps the reference's blockwise online-softmax form, so both packages
accumulate in the same order; it is the plain version of the port's
flash-attention kernel (``repro_torch.kernels.flash_attention``), which the
prefill path calls.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ----------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# ----------------------------------------------------------------- RoPE


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions [..., T] -> (cos, sin) [..., T, dim/2], fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., T, H, dh]; cos/sin broadcastable [..., T, 1, dh/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------- blockwise attention


def _block_attn_loop(q, k, v, q_offset: int, causal: bool, kv_len,
                     block: int, scale: float, return_lse: bool = False):
    """Online-softmax attention: loop over KV blocks.

    q: [B, Tq, H, dh]   k/v: [B, Tk, Hkv, dh]  (Tk padded to block multiple)
    kv_len: [B] valid KV length (None -> all valid)
    Returns [B, Tq, H, dh], and with ``return_lse`` also each row's
    log-sum-exp of its scaled scores, m + log l, f32 [B, H, Tq].
    """
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    dh_v = v.shape[-1]
    assert Tk % block == 0, (Tk, block)
    groups = H // Hkv
    dev = q.device
    # [B, Hkv, groups, Tq, dh]: grouped GQA, no repeated K/V materialized.
    qf = (q.float() * scale).transpose(1, 2).reshape(B, Hkv, groups, Tq, dh)
    m = torch.full((B, Hkv, groups, Tq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, groups, Tq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Hkv, groups, Tq, dh_v), dtype=torch.float32,
                    device=dev)
    qpos = q_offset + torch.arange(Tq, device=dev)
    for blk in range(Tk // block):
        kb = k[:, blk * block:(blk + 1) * block].float()
        vb = v[:, blk * block:(blk + 1) * block].float()
        s = torch.einsum("bngqd,bknd->bngqk", qf, kb)
        kpos = blk * block + torch.arange(block, device=dev)
        mask = torch.ones((B, 1, 1, Tq, block), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos[None, None, None, None, :]
                           <= qpos[None, None, None, :, None])
        if kv_len is not None:
            mask = mask & (kpos[None, None, None, None, :]
                           < kv_len[:, None, None, None, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bngqk,bknd->bngqd", p, vb)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    o = o.reshape(B, H, Tq, dh_v).transpose(1, 2).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l)).reshape(B, H, Tq)
    return o


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len=None, block: int = 512, scale: Optional[float] = None,
              return_lse: bool = False):
    """Flash-style blockwise multi-head attention (GQA via head groups).

    Pads KV to a block multiple; masking handles the tail.  With
    ``return_lse`` returns (out, lse [B, H, Tq] f32) (see
    :func:`_block_attn_loop`).
    """
    dh = q.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    Tk = k.shape[1]
    block = min(block, max(Tk, 1))
    pad = (-Tk) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((q.shape[0],), Tk, dtype=torch.int32,
                                device=q.device)
    return _block_attn_loop(q, k, v, q_offset, causal, kv_len, block, scale,
                            return_lse)


# ----------------------------------------------------------------- MLPs


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU with the gate's SiLU in f32.  Where no autograd graph is
    recorded (serving) the SiLU and the product run in place and the up
    projection waits until the gate's f32 copy is gone: the same values,
    half the temporaries at their peak."""
    if torch.is_grad_enabled():
        g = x @ w_gate
        u = x @ w_up
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = F.silu((x @ w_gate).float(), inplace=True).to(x.dtype)
        h.mul_(x @ w_up)
    return h @ w_down


def head_proj(x, w):
    """x [B,T,d] @ w [d, heads, dh] -> [B,T,heads,dh]."""
    B, T, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, T, w.shape[1], w.shape[2])


def out_proj(o, wo):
    """o [B,T,H,dh] @ wo [H, dh, d] -> [B,T,d]."""
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def gqa_qkv(x, wq, wk, wv, bq=None, bk=None, bv=None):
    """x [B,T,d]; w* [d, heads, dh] -> q [B,T,H,dh], k/v [B,T,Hkv,dh]."""
    q, k, v = head_proj(x, wq), head_proj(x, wk), head_proj(x, wv)
    if bq is not None:
        q = q + bq
        k = k + bk
        v = v + bv
    return q, k, v
