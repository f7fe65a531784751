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

Serving over a mesh (a serving :class:`~repro_torch.models.common.
ParallelCtx` whose ``model`` axis :func:`heads_split` cuts) runs each block
on the rank's heads: the LM holds the leaves' head cut
(:func:`head_ranges`: the rank's ``z``, ``x`` and ``dt`` columns of
``w_in``, ``B`` and ``C`` whole when there is one group, its channels of
``conv_w`` / ``conv_b``, its heads' ``A_log`` / ``D`` / ``dt_bias``, its
slice of ``norm_w`` and its rows of ``w_out``), the SSD scan runs at
nh / tp heads, the gated RMSNorm sums its squares over ``model`` before it
divides (it normalises the whole d_inner), and the row-parallel ``w_out``
ends in one reduce over ``model``.  A rank's decode state is its heads'
``ssm`` and its channels' ``conv``.  The reference's GSPMD keeps these
leaves cut contiguously, which no head-local computation can use.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.common import (
    ParallelCtx,
    ckpt,
    dense_init_,
    empty_param,
    explicit,
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


def state_shapes(cfg: ModelConfig, L: int, B: int, nh: int, conv_dim: int):
    """(ssm_state, conv_state) shapes for a stacked L-layer SSM at ``nh``
    heads and ``conv_dim`` conv channels (the whole block's, or a serving
    rank's)."""
    s = cfg.ssm
    return ((L, B, nh, s.head_dim, s.d_state),
            (L, B, s.d_conv - 1, conv_dim))


def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether a serving mesh's ``model`` axis of ``tp`` runs the Mamba-2
    blocks on each rank's heads: whenever tp > 1.  Raises ValueError where
    a rank has no share to run: the heads do not divide by tp, or the B / C
    groups are neither one (whole on every rank) nor a multiple of tp (the
    rank's groups, which its heads read)."""
    if tp <= 1:
        return False
    _d_in, nh, _cd = dims(cfg)
    G = cfg.ssm.n_groups
    if nh % tp or (G > 1 and G % tp):
        raise ValueError(f"a model axis of {tp} cannot split the Mamba-2 "
                         f"blocks' {nh} heads in {G} groups by heads")
    return True


def head_ranges(cfg: ModelConfig, leaf: str, tp: int, rank: int
                ) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """The serving cut of the Mamba-2 leaf ``leaf`` on model rank ``rank``
    of ``tp`` (:func:`heads_split` holds): (dim, [(lo, hi), ...]), the
    ranges of ``dim`` whose concatenation is the rank's shard, or None for
    a leaf of another name.  ``w_in``'s projection is ``z | x | B | C |
    dt`` and the conv channels ``x | B | C``."""
    s = cfg.ssm
    d_in, nh, _cd = dims(cfg)
    G, N = s.n_groups, s.d_state
    gn = G * N
    dl, hl = d_in // tp, nh // tp
    g0, gl = (rank * (G // tp), G // tp) if G > 1 else (0, 1)
    chans = (rank * dl, (rank + 1) * dl)
    heads = (rank * hl, (rank + 1) * hl)

    def at(r, by):
        return r[0] + by, r[1] + by
    groups = (g0 * N, (g0 + gl) * N)
    xbc = [chans, at(groups, d_in), at(groups, d_in + gn)]
    cuts = {"w_in": (-1, [chans, *(at(r, d_in) for r in xbc),
                          at(heads, 2 * d_in + 2 * gn)]),
            "conv_w": (-1, xbc), "conv_b": (-1, xbc),
            "A_log": (-1, [heads]), "D": (-1, [heads]),
            "dt_bias": (-1, [heads]), "norm_w": (-1, [chans]),
            "w_out": (-2, [chans])}
    return cuts.get(leaf)


def mesh_heads(cfg: ModelConfig, par: Optional[ParallelCtx]) -> bool:
    """Whether the blocks run on this rank's heads under ``par``."""
    return explicit(par) and heads_split(cfg, par.tp)


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


def _local_dims(cfg: ModelConfig, p):
    """(d_inner, heads, conv channels, groups) of the block whose weights
    ``p`` holds: the whole block's, or a serving rank's head cut."""
    d_in, nh, cd = (p["norm_w"].shape[-1], p["A_log"].shape[-1],
                    p["conv_b"].shape[-1])
    return d_in, nh, cd, (cd - d_in) // (2 * cfg.ssm.d_state)


def _split_proj(d_in: int, gn: int, zxbcdt):
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xBC, dt


def _sum_sq_over_model(par: ParallelCtx, ss):
    """The gated norm's sum of squares over every model rank's heads
    (chip_smoke.py's ``ssm_norm`` fault replaces it by the rank's own)."""
    return par.reduce_from_model(ss)


def _gated_norm(cfg: ModelConfig, p, y, z, par):
    """``rms_norm(y * silu(z), norm_w)`` over the whole d_inner; on a
    rank's heads the f32 sum of squares [..., 1] is summed over ``model``
    before it divides."""
    g = y * F.silu(z.float()).to(y.dtype)
    if not mesh_heads(cfg, par):
        return rms_norm(g, p["norm_w"], cfg.norm_eps)
    g32 = g.float()
    ss = _sum_sq_over_model(par, g32.square().sum(dim=-1, keepdim=True))
    var = ss / (g.shape[-1] * par.tp)
    return (g32 * torch.rsqrt(var + cfg.norm_eps)).to(g.dtype) * p["norm_w"]


def _out(cfg: ModelConfig, p, y, par):
    """The row-parallel ``w_out``, reduced over ``model`` on a rank's
    heads."""
    out = y @ p["w_out"]
    return par.reduce_from_model(out) if mesh_heads(cfg, par) else out


def ssd_chunked(xh, dt, A, Bg, Cg, chunk: int, h0=None):
    """Chunked SSD scan through the port's kernel.

    xh [B,T,nh,hd]; dt [B,T,nh] (post-softplus); A [nh] (negative);
    Bg/Cg [B,T,G,N], the un-expanded groups (head h reads group
    h // (nh // G)).  Returns (y [B,T,nh,hd] f32, h_final [B,nh,hd,N])."""
    return ssd_scan(xh.contiguous(), dt.float().contiguous(), A.contiguous(),
                    Bg.contiguous(), Cg.contiguous(), chunk=chunk, h0=h0)


def mamba_block_train(cfg: ModelConfig, p, x, *, h0=None, conv0=None,
                      return_state: bool = False,
                      par: Optional[ParallelCtx] = None):
    """x [B,T,d] -> y [B,T,d] (+ (h_final, conv_tail) with
    ``return_state``: the prefill path).  ``par``: a serving mesh, ``p``
    this rank's head cut (module docstring; h_final and conv_tail are the
    rank's heads and channels)."""
    s = cfg.ssm
    d_in, nh, conv_dim, G = _local_dims(cfg, p)
    Bsz, T = x.shape[:2]
    zxbcdt = x @ p["w_in"]
    z, xBC, dt = _split_proj(d_in, G * s.d_state, zxbcdt)
    xBC_pre = xBC                                          # pre-conv (cache)
    if conv0 is not None:
        xBC_in = torch.cat([conv0, xBC], dim=1)
        xBC = _causal_conv(xBC_in, p["conv_w"],
                           p["conv_b"])[:, conv0.shape[1]:]
    else:
        xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    gn = G * s.d_state
    xp = xBC[..., :d_in]
    Bg = xBC[..., d_in: d_in + gn].reshape(Bsz, T, G, s.d_state)
    Cg = xBC[..., d_in + gn:].reshape(Bsz, T, G, s.d_state)
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
    out = _out(cfg, p, _gated_norm(cfg, p, y, z, par), par)
    if return_state:
        ctx = (torch.zeros((Bsz, s.d_conv - 1, conv_dim), dtype=x.dtype,
                           device=x.device) if conv0 is None else conv0)
        conv_tail = torch.cat([ctx, xBC_pre], dim=1)[:, -(s.d_conv - 1):]
        return out, (h_last, conv_tail)
    return out


def mamba_block_decode(cfg: ModelConfig, p, x, h, conv_cache,
                       par: Optional[ParallelCtx] = None):
    """One-token recurrent update.

    x [B,1,d]; h [B,nh,hd,N] f32; conv_cache [B,d_conv-1,conv_dim]
    -> (y [B,1,d], h', conv_cache').  ``par``: a serving mesh, ``p`` this
    rank's head cut, ``h`` and ``conv_cache`` its heads and channels."""
    s = cfg.ssm
    d_in, nh, _conv_dim, G = _local_dims(cfg, p)
    zxbcdt = x @ p["w_in"]
    z, xBC, dt = _split_proj(d_in, G * s.d_state, zxbcdt)
    window = torch.cat([conv_cache, xBC], dim=1)           # [B,d_conv,cd]
    conv_out = (window * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    conv_cache = window[:, 1:]
    xBC1 = F.silu(conv_out.float()).to(x.dtype)
    gn = G * s.d_state
    xp = xBC1[..., :d_in]
    Bg = xBC1[..., d_in: d_in + gn].reshape(-1, G, s.d_state)
    Cg = xBC1[..., d_in + gn:].reshape(-1, G, s.d_state)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    hpg = nh // G
    Bh = torch.repeat_interleave(Bg, hpg, dim=1)           # [B,nh,N]
    Ch = torch.repeat_interleave(Cg, hpg, dim=1)
    xh = xp.reshape(-1, nh, s.head_dim).float()
    dA = torch.exp(dt1 * A[None, :])                       # [B,nh]
    h = h * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt1, xh, Bh.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(-1, 1, d_in).to(x.dtype)
    return _out(cfg, p, _gated_norm(cfg, p, y, z, par), par), h, conv_cache


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


def ssm_stack_prefill(cfg: ModelConfig, params: SSMStackParams, x,
                      par: Optional[ParallelCtx] = None):
    """Returns (x, ssm_states [L,B,nh,hd,N], conv_states [L,B,K-1,cd]);
    ``par``: a serving mesh (module docstring; the rank's heads and
    channels of the states)."""
    hs, convs = [], []
    for l in range(params.n_layers):
        y, (h, conv) = mamba_block_train(
            cfg, params.mamba.layer(l),
            rms_norm(x, params.ln[l], cfg.norm_eps), return_state=True,
            par=par)
        x = x + y
        hs.append(h)
        convs.append(conv)
    return x, torch.stack(hs), torch.stack(convs)


def ssm_stack_decode(cfg: ModelConfig, params: SSMStackParams, x,
                     ssm_state, conv_state,
                     par: Optional[ParallelCtx] = None):
    """One token through every layer; returns (x, ssm_states',
    conv_states'); ``par`` as :func:`ssm_stack_prefill`'s."""
    hs, convs = [], []
    for l in range(params.n_layers):
        y, h, conv = mamba_block_decode(
            cfg, params.mamba.layer(l),
            rms_norm(x, params.ln[l], cfg.norm_eps), ssm_state[l],
            conv_state[l], par)
        x = x + y
        hs.append(h)
        convs.append(conv)
    return x, torch.stack(hs), torch.stack(convs)
