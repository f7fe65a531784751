"""Mamba-2 (SSD, state-space duality) blocks: chunked prefill scan and decode.

Counterpart of the reference's ``models/mamba2.py``: prefill, the recurrent
decode step and the training stack (:func:`ssm_stack_train`).  Per chunk
the scan is a quadratic, attention-like intra-chunk term plus an
inter-chunk linear recurrence on the [heads, head_dim, d_state] state;
:func:`ssd_chunked` runs it through the port's SSD-scan kernel (its plain
version on CPU tensors).  Decode is the O(1) recurrent update in plain
torch ops, as the reference's is plain ``jnp``.  Weights stay stacked over
leading layer axes in the reference's shapes (``w_in [L, d, proj]``, ...);
the reference's ``lax.scan`` over layers is a Python loop.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import (
    ckpt,
    dense_init_,
    empty_param,
    layer_remat,
    unbind_layers,
)
from repro_torch.models.layers import rms_norm


def dims(cfg: ModelConfig):
    """(d_inner, heads, conv channels) of one Mamba-2 block."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def state_shapes(cfg: ModelConfig, L: int, B: int):
    """(ssm_state, conv_state) shapes for a stacked L-layer SSM."""
    s = cfg.ssm
    _d_in, nh, conv_dim = dims(cfg)
    return ((L, B, nh, s.head_dim, s.d_state),
            (L, B, s.d_conv - 1, conv_dim))


class MambaParams(nn.Module):
    """Mamba-2 block weights stacked over ``lead`` axes (``(L,)`` or the
    hybrid's ``(G, period)``), with the reference's leaf names: w_in
    [*lead, d, proj], conv_w [*lead, d_conv, conv_dim], conv_b, A_log, D,
    dt_bias, norm_w [*lead, d_inner], w_out [*lead, d_inner, d]."""

    def __init__(self, cfg: ModelConfig, lead: Tuple[int, ...], dtype,
                 device):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_in, nh, conv_dim = dims(cfg)
        proj = 2 * d_in + 2 * s.n_groups * s.d_state + nh
        self.w_in = empty_param((*lead, d, proj), dtype, device)
        self.conv_w = empty_param((*lead, s.d_conv, conv_dim), dtype, device)
        self.conv_b = empty_param((*lead, conv_dim), dtype, device)
        self.A_log = empty_param((*lead, nh), dtype, device)
        self.D = empty_param((*lead, nh), dtype, device)
        self.dt_bias = empty_param((*lead, nh), dtype, device)
        self.norm_w = empty_param((*lead, d_in), dtype, device)
        self.w_out = empty_param((*lead, d_in, d), dtype, device)
        self._in_axis = len(lead)

    def init_(self, gen: torch.Generator) -> None:
        """The reference's ``init_mamba_params`` distributions."""
        for name in ("w_in", "conv_w", "w_out"):
            dense_init_(getattr(self, name), self._in_axis, gen)
        nh = self.A_log.shape[-1]
        self.A_log.data.copy_(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.conv_b.data.zero_()
        self.D.data.fill_(1.0)
        self.dt_bias.data.zero_()
        self.norm_w.data.fill_(1.0)

    def layer(self, *idx) -> Dict[str, torch.Tensor]:
        """One layer's weight slices (``idx`` indexes the lead axes)."""
        return {n: p[idx] for n, p in self.named_parameters()}


class SSMStackParams(nn.Module):
    """The ssm family's decoder: ln [L, d] and L stacked Mamba-2 blocks."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        self.ln = empty_param((L, cfg.d_model), dtype, device)
        self.mamba = MambaParams(cfg, (L,), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln.data.fill_(1.0)
        self.mamba.init_(gen)

    @property
    def n_layers(self) -> int:
        return self.ln.shape[0]

    def train_layers(self, dtype):
        """Every layer's ``{"ln", "mamba": {...}}`` tree, each stacked
        weight cast to ``dtype`` once (:func:`unbind_layers`)."""
        return unbind_layers(self.named_parameters(), dtype, self.n_layers)


# ------------------------------------------------------------------ block


def _causal_conv(u, w, b):
    """Depthwise causal conv along T.  u [B,T,C], w [K,C], b [C]."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + pad[:, i: i + u.shape[1], :] * w[i]
    return out + b


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_in, _nh, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xBC, dt


def ssd_chunked(xh, dt, A, Bg, Cg, chunk: int, h0=None):
    """Chunked SSD scan through the port's kernel.

    xh [B,T,nh,hd]; dt [B,T,nh] (post-softplus); A [nh] (negative);
    Bg/Cg [B,T,G,N], the un-expanded groups (head h reads group
    h // (nh // G)).  Returns (y [B,T,nh,hd] f32, h_final [B,nh,hd,N])."""
    return ssd_scan(xh.contiguous(), dt.float().contiguous(), A.contiguous(),
                    Bg.contiguous(), Cg.contiguous(), chunk=chunk, h0=h0)


def mamba_block_train(cfg: ModelConfig, p, x, *, h0=None, conv0=None,
                      return_state: bool = False):
    """x [B,T,d] -> y [B,T,d] (+ (h_final, conv_tail) with
    ``return_state``: the prefill path)."""
    s = cfg.ssm
    d_in, nh, conv_dim = dims(cfg)
    Bsz, T = x.shape[:2]
    zxbcdt = x @ p["w_in"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC_pre = xBC                                          # pre-conv (cache)
    if conv0 is not None:
        xBC_in = torch.cat([conv0, xBC], dim=1)
        xBC = _causal_conv(xBC_in, p["conv_w"],
                           p["conv_b"])[:, conv0.shape[1]:]
    else:
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    gn = s.n_groups * s.d_state
    xp = xBC[..., :d_in]
    Bg = xBC[..., d_in: d_in + gn].reshape(Bsz, T, s.n_groups, s.d_state)
    Cg = xBC[..., d_in + gn:].reshape(Bsz, T, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = xp.reshape(Bsz, T, nh, s.head_dim)
    # Pad T to a chunk multiple; dt = 0 rows are inert (decay 1, no input).
    chunk = min(s.chunk, T)
    pad = (-T) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, pad))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, pad))
    y, h_last = ssd_chunked(xh, dt, A, Bg, Cg, chunk, h0=h0)
    if pad:
        y = y[:, :T]
        xh = xh[:, :T]
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, T, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"],
                 cfg.norm_eps)
    out = y @ p["w_out"]
    if return_state:
        ctx = (torch.zeros((Bsz, s.d_conv - 1, conv_dim), dtype=x.dtype,
                           device=x.device) if conv0 is None else conv0)
        conv_tail = torch.cat([ctx, xBC_pre], dim=1)[:, -(s.d_conv - 1):]
        return out, (h_last, conv_tail)
    return out


def mamba_block_decode(cfg: ModelConfig, p, x, h, conv_cache):
    """One-token recurrent update.

    x [B,1,d]; h [B,nh,hd,N] f32; conv_cache [B,d_conv-1,conv_dim]
    -> (y [B,1,d], h', conv_cache')
    """
    s = cfg.ssm
    d_in, nh, _conv_dim = dims(cfg)
    zxbcdt = x @ p["w_in"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv_cache, xBC], dim=1)           # [B,d_conv,cd]
    conv_out = (window * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    conv_cache = window[:, 1:]
    xBC1 = F.silu(conv_out.float()).to(x.dtype)
    gn = s.n_groups * s.d_state
    xp = xBC1[..., :d_in]
    Bg = xBC1[..., d_in: d_in + gn].reshape(-1, s.n_groups, s.d_state)
    Cg = xBC1[..., d_in + gn:].reshape(-1, s.n_groups, s.d_state)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    hpg = nh // s.n_groups
    Bh = torch.repeat_interleave(Bg, hpg, dim=1)           # [B,nh,N]
    Ch = torch.repeat_interleave(Cg, hpg, dim=1)
    xh = xp.reshape(-1, nh, s.head_dim).float()
    dA = torch.exp(dt1 * A[None, :])                       # [B,nh]
    h = h * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, xh, Bh.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(-1, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm_w"],
                 cfg.norm_eps)
    return y @ p["w_out"], h, conv_cache


# ------------------------------------------------------------------ stack


def _ssm_layer_train(cfg: ModelConfig, lp, x):
    return x + mamba_block_train(cfg, lp["mamba"],
                                 rms_norm(x, lp["ln"], cfg.norm_eps))


def ssm_stack_train(cfg: ModelConfig, layers, x, *, remat=True):
    """The ssm stack's training forward over its per-layer trees
    (:meth:`SSMStackParams.train_layers`), each layer recomputed in the
    backward unless ``remat`` is False or "none" (the reference's
    ``ssm_stack_train``).  Under grad mode each layer's scan runs
    :class:`~repro_torch.kernels.ssd_scan.SSDScanFn`."""
    on = layer_remat(remat)
    for lp in layers:
        x = ckpt(_ssm_layer_train, cfg, lp, x) if on \
            else _ssm_layer_train(cfg, lp, x)
    return x


def ssm_stack_prefill(cfg: ModelConfig, params: SSMStackParams, x):
    """Returns (x, ssm_states [L,B,nh,hd,N], conv_states [L,B,K-1,cd])."""
    hs, convs = [], []
    for l in range(params.n_layers):
        y, (h, conv) = mamba_block_train(
            cfg, params.mamba.layer(l),
            rms_norm(x, params.ln[l], cfg.norm_eps), return_state=True)
        x = x + y
        hs.append(h)
        convs.append(conv)
    return x, torch.stack(hs), torch.stack(convs)


def ssm_stack_decode(cfg: ModelConfig, params: SSMStackParams, x,
                     ssm_state, conv_state):
    """One token through every layer; returns (x, ssm_states',
    conv_states')."""
    hs, convs = [], []
    for l in range(params.n_layers):
        y, h, conv = mamba_block_decode(
            cfg, params.mamba.layer(l),
            rms_norm(x, params.ln[l], cfg.norm_eps), ssm_state[l],
            conv_state[l])
        x = x + y
        hs.append(h)
        convs.append(conv)
    return x, torch.stack(hs), torch.stack(convs)
