"""Decoder-only transformer stack (mesh-free): dense, MoE and MLA layers.

Counterpart of the ``mesh is None`` paths of the reference's
``models/transformer.py``.  Weights stay stacked over a leading layer axis in
the reference's shapes (``wq [L, d, H, dh]``, ``wo [L, H, dh, d]``, ...); the
reference's ``lax.scan`` over layers is a Python loop over layer slices.
A layer's attention is GQA or, with ``cfg.mla``, Multi-head Latent
Attention (:mod:`repro_torch.models.mla`); its FFN is SwiGLU or, with
``cfg.moe``, the routed experts of :mod:`repro_torch.models.moe`.

  * prefill: full-sequence causal attention through the flash-attention
    kernel (plain version on CPU tensors), plus an en-masse scatter of each
    layer's K/V (MLA: its latent payloads) into its pool slice.  Dense
    layers run their row-wise work on fixed-shape row blocks
    (:data:`PREFILL_ROWS`), so a suffix row gets the full prefill's bits,
    and suffix-only prefill prepends a cached prefix's K/V to the keys and
    writes only the suffix pages; MoE and MLA stacks have no prefix cache
    (as the reference) and run each layer over the whole prompt;
  * decode: one token per sequence, written into the paged pool and
    attended through the paged decode-attention kernel (plain version on
    CPU tensors), or, when the step carries staged pages
    (``PageCtx.slots``), through the fused gather-attend kernel;
  * train: the full-sequence forward over per-layer weight trees
    (:meth:`DecoderParams.train_layers`) under grad mode, where the flash
    call runs its autograd function (the hand-written backward; MLA's at
    key width 192 and value width 128), with per-layer activation
    recomputation; MoE layers also return their load-balance aux loss,
    summed over the stack (:func:`decoder_stack_train`).  Over a ``model``
    axis > 1 under megatron (a :class:`~repro_torch.models.common.ParallelCtx`
    that is ``explicit``) the attention and the SwiGLU run as the
    reference's explicit ``shard_map`` blocks on this rank's model shards:
    the Megatron attention over this rank's query heads
    (:func:`tp_geometry`) and the column / row-parallel SwiGLU, each ending
    in one reduce-from-model.

Serving over a mesh (a ``par`` from
:func:`~repro_torch.models.common.serving_ctx`, the reference's mesh
branches) runs on this rank's serving shard of the weights
(``launch/sharding.py``'s ``serving_param_specs``) and its stripe of the
pools: prefill through the Megatron attention and TP SwiGLU above on the
whole prompt (no row blocks: a mesh has no prefix cache), the K / V
gathered over ``model`` where the block split them and written into this
rank's pages; decode with q gathered over ``model`` (the paged kernel
needs every head on every page shard), the partials combined across the
page group, the output projection over this rank's heads reduced over
``model``; MoE layers through the serving 2-D EP
(:mod:`repro_torch.models.moe`).

Pools are updated in place.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (
    ParallelCtx,
    ckpt,
    dense_init_,
    empty_param,
    explicit,
    layer_remat,
    merge_parts,
    on_mesh,
    unbind_layers,
)
from repro_torch.models.layers import (
    apply_rope,
    gqa_qkv,
    head_proj,
    out_proj,
    rms_norm,
    rope_angles,
    swiglu,
)
from repro_torch.models.mla import (
    MLAParams,
    mla_block_decode,
    mla_block_prefill,
    mla_block_train,
)
from repro_torch.models.moe import MoEParams, moe_block, moe_parts
from repro_torch.models.page_ops import (
    PageCtx,
    paged_attn_op,
    prefill_write_op,
)


# ------------------------------------------------------------------ params


class AttnParams(nn.Module):
    """Attention weights stacked over layers: wq [L,d,H,dh], wk/wv
    [L,d,Hkv,dh], wo [L,H,dh,d], with ``qkv_bias`` bq [L,H,dh], bk/bv
    [L,Hkv,dh], and with ``qk_norm`` the per-head RMSNorm weights q_norm /
    k_norm [L,dh].  ``L=None`` drops the layer axis (the hybrid family's
    shared block)."""

    def __init__(self, cfg: ModelConfig, L: Optional[int], dtype, device):
        super().__init__()
        d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        lead = () if L is None else (L,)
        self.wq = empty_param((*lead, d, H, dh), dtype, device)
        self.wk = empty_param((*lead, d, Hkv, dh), dtype, device)
        self.wv = empty_param((*lead, d, Hkv, dh), dtype, device)
        self.wo = empty_param((*lead, H, dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = empty_param((*lead, H, dh), dtype, device)
            self.bk = empty_param((*lead, Hkv, dh), dtype, device)
            self.bv = empty_param((*lead, Hkv, dh), dtype, device)
        if cfg.qk_norm:
            self.q_norm = empty_param((*lead, dh), dtype, device)
            self.k_norm = empty_param((*lead, dh), dtype, device)
        self._in_axis = len(lead)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv", "wo"):
            dense_init_(getattr(self, name), self._in_axis, gen)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).data.zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(self, name):
                getattr(self, name).data.fill_(1.0)


class FFNParams(nn.Module):
    """SwiGLU weights stacked over layers: w_gate/w_up [L,d,f], w_down
    [L,f,d]; ``L=None`` drops the layer axis."""

    def __init__(self, cfg: ModelConfig, L: Optional[int], dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        lead = () if L is None else (L,)
        self.w_gate = empty_param((*lead, d, f), dtype, device)
        self.w_up = empty_param((*lead, d, f), dtype, device)
        self.w_down = empty_param((*lead, f, d), dtype, device)
        self._in_axis = len(lead)

    def init_(self, gen: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            dense_init_(getattr(self, name), self._in_axis, gen)


class DecoderParams(nn.Module):
    """Stacked decoder-layer weights (the reference's ``init_decoder_params``):
    ``attn`` holds MLA weights when ``cfg.mla`` is set, and the FFN is
    ``moe`` when ``cfg.moe`` is set, else ``mlp``."""

    def __init__(self, cfg: ModelConfig, L: int, dtype, device):
        super().__init__()
        self.ln1 = empty_param((L, cfg.d_model), dtype, device)
        self.ln2 = empty_param((L, cfg.d_model), dtype, device)
        if cfg.mla is not None:
            self.attn = MLAParams(cfg, L, dtype, device)
        else:
            self.attn = AttnParams(cfg, L, dtype, device)
        self.ffn_name = "mlp" if cfg.moe is None else "moe"
        self.add_module(self.ffn_name,
                        FFNParams(cfg, L, dtype, device) if cfg.moe is None
                        else MoEParams(cfg, L, dtype, device))

    def init_(self, gen: torch.Generator) -> None:
        self.ln1.data.fill_(1.0)
        self.ln2.data.fill_(1.0)
        self.attn.init_(gen)
        getattr(self, self.ffn_name).init_(gen)

    def layer(self, l: int) -> Dict[str, object]:
        """Layer ``l``'s weight slices as the reference's per-layer tree."""
        ffn = getattr(self, self.ffn_name)
        return {
            "ln1": self.ln1[l], "ln2": self.ln2[l],
            "attn": {n: p[l] for n, p in self.attn.named_parameters()},
            self.ffn_name: {n: p[l] for n, p in ffn.named_parameters()},
        }

    @property
    def n_layers(self) -> int:
        return self.ln1.shape[0]

    def train_layers(self, dtype) -> List[Dict[str, object]]:
        """Every layer's weights as :meth:`layer`'s tree (with a subclass's
        groups, e.g. encdec's ``cross`` and ``ln_cross``), cast to
        ``dtype``, each stacked weight once (:func:`unbind_layers`)."""
        return unbind_layers(self.named_parameters(), dtype, self.n_layers)


# ------------------------------------------------------------------ attention


def _project_qkv(cfg: ModelConfig, p, x, positions):
    """x [B,T,d] -> roped q [B,T,H,dh], k/v [B,T,Hkv,dh]; with
    ``qk_norm`` each head of q and k is RMS-normed before RoPE."""
    q, k, v = gqa_qkv(x, p["wq"], p["wk"], p["wv"],
                      p.get("bq"), p.get("bk"), p.get("bv"))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, q.shape[-1], cfg.rope_theta)
    q = apply_rope(q, cos[..., :, None, :], sin[..., :, None, :])
    k = apply_rope(k, cos[..., :, None, :], sin[..., :, None, :])
    return q, k, v


# Prefill's row-wise work (norms, projections, RoPE, SwiGLU) runs on blocks
# of this many rows, the last zero-padded, so that every matrix product and
# row reduction of prefill has one shape whatever the prompt's length.  A
# library picks its kernel, and with it the summation order, by shape:
# cuBLAS on the H100 sums a 64-row product over 11008 inputs in another
# order than a 576-row one.  Without the blocks a suffix prefill would not
# reproduce the full prefill's bits, and the prefix cache could change
# tokens.
PREFILL_ROWS = 512


def _row_blocks(fn, *xs):
    """``fn`` applied to [B, T, ...] inputs in blocks of PREFILL_ROWS rows
    (the last zero-padded); returns its output tensor(s) for the T rows."""
    T = xs[0].shape[1]
    pad = (-T) % PREFILL_ROWS
    if pad:
        xs = [torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))],
                        dim=1) for x in xs]
    outs = [fn(*(x[:, i:i + PREFILL_ROWS] for x in xs))
            for i in range(0, T + pad, PREFILL_ROWS)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1)[:, :T].contiguous()
                     for parts in zip(*outs))
    return torch.cat(outs, dim=1)[:, :T].contiguous()


def _attn_in(cfg: ModelConfig, lp, x, positions):
    """Rows of the residual stream -> the layer's roped q, k, v."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    return _project_qkv(cfg, lp["attn"], h, positions)


def _attn_out_ffn(cfg: ModelConfig, lp, x, o):
    """Rows of the residual stream and of the attention output -> the
    layer's output rows (output projection, residual, norm, SwiGLU)."""
    x = x + out_proj(o, lp["attn"]["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn_block(cfg, lp["mlp"], h)


def prefill_attention(q, k, v, prefix_kv=None, causal=True, site=None):
    """Causal (or, for an encoder, non-causal) attention of q [B,T,H,dh]
    over k/v [B,T,Hkv,dh].  ``prefix_kv=(pk, pv)`` ([B, P, Hkv, dh],
    already roped: cached pool bytes) prepends P cached-context keys the
    in-flight queries, at positions P.., attend to (suffix-only prefill).
    ``site``: the flash call's site counter, if any."""
    if prefix_kv is None:
        return flash_attention(q, k, v, causal=causal, site=site)
    pk, pv = prefix_kv
    return flash_attention(q, torch.cat([pk.to(k.dtype), k], dim=1),
                           torch.cat([pv.to(v.dtype), v], dim=1),
                           q_offset=pk.shape[1])


def attn_block_prefill(cfg: ModelConfig, p, x, positions, causal=True,
                       site=None):
    """Full-sequence attention block (the reference's ``attn_block_train``
    without a cached prefix; ``causal=False`` for an encoder): x [B,T,d]
    -> (out [B,T,d], k, v [B,T,Hkv,dh]); the attention runs the flash
    kernel."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = prefill_attention(q, k, v, causal=causal, site=site)
    return out_proj(o, p["wo"]), k, v


def tp_geometry(cfg: ModelConfig, tp: int):
    """Static explicit-TP geometry at a ``model`` axis of ``tp``, or None if
    this config can't use it (the reference's ``_tp_geometry``).

    Each model shard owns H_loc consecutive query heads and the (static)
    kv-head slice they attend to; returns (tp, H_loc, nkv_loc, kv_lo_of)
    where kv_lo_of[s] is shard s's first kv head.  None when heads don't
    divide, or a shard's q heads map to a non-uniform kv block (the
    grouped attention inside the shard would be wrong).
    """
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if H == 0 or H % tp or H % Hkv:
        return None
    H_loc, group = H // tp, H // Hkv
    kv_lo, span = [], 0
    for s in range(tp):
        lo = (s * H_loc) // group
        hi = (s * H_loc + H_loc - 1) // group
        kv_lo.append(lo)
        span = max(span, hi - lo + 1)
    # Uniform grouped mapping inside the shard requires H_loc % span == 0
    # and every local q head j hitting kv (lo + j // (H_loc // span)).
    if H_loc % span:
        return None
    for s in range(tp):
        for j in range(H_loc):
            if (s * H_loc + j) // group != kv_lo[s] + j // (H_loc // span):
                return None
    return tp, H_loc, span, tuple(kv_lo)


def kv_sharded(cfg: ModelConfig, geo) -> bool:
    """Whether shard s's q heads attend exactly its 1 / tp of the kv heads:
    then the kv projection is split too (the reference's ``kv_sharded``);
    otherwise every shard computes k / v in full and slices its block."""
    tp, _, nkv, kv_lo = geo
    Hkv = cfg.n_kv_heads
    return (Hkv % tp == 0 and nkv == Hkv // tp
            and all(kv_lo[s] == s * (Hkv // tp) for s in range(tp)))


def _attn_block_train_tp(cfg: ModelConfig, p, x, positions,
                         par: ParallelCtx, geo, causal, site):
    """The reference's ``_attn_block_train_tp`` on this rank's shard,
    before its reduce: q and the output projection over this rank's H_loc
    heads (wq, bq, wo local); k / v from the local kv projection when
    :func:`kv_sharded`, else computed in full from the replicated kv
    weights and sliced at this shard's kv block (made contiguous: the
    flash kernel takes whole tensors).  x, the replicated kv weights and
    q_norm / k_norm enter by copy-to-model.  Returns (partial out, k, v)."""
    _, _, nkv, kv_lo = geo
    sharded = kv_sharded(cfg, geo)

    def kv_weight(name):
        return p[name] if sharded else par.copy_to_model(p[name])

    x = par.copy_to_model(x)
    q = head_proj(x, p["wq"])
    k = head_proj(x, kv_weight("wk"))
    v = head_proj(x, kv_weight("wv"))
    if "bq" in p:
        q = q + p["bq"]
        k = k + kv_weight("bk")
        v = v + kv_weight("bv")
    if cfg.qk_norm:
        q = rms_norm(q, par.copy_to_model(p["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, par.copy_to_model(p["k_norm"]), cfg.norm_eps)
    cos, sin = rope_angles(positions, q.shape[-1], cfg.rope_theta)
    q = apply_rope(q, cos[..., :, None, :], sin[..., :, None, :])
    k = apply_rope(k, cos[..., :, None, :], sin[..., :, None, :])
    if sharded:
        k_loc, v_loc = k, v
    else:
        lo = kv_lo[par.model_rank]
        k_loc = k[:, :, lo:lo + nkv].contiguous()
        v_loc = v[:, :, lo:lo + nkv].contiguous()
    o = flash_attention(q, k_loc, v_loc, causal=causal, site=site)
    return out_proj(o, p["wo"]), k, v


def attn_block_train(cfg: ModelConfig, p, x, positions, causal=True,
                     site=None, par: Optional[ParallelCtx] = None,
                     reduce=True):
    """The reference's ``attn_block_train`` without a cached prefix; under
    grad mode its flash call runs the kernel's autograd function.  With an
    explicit ``par`` and a :func:`tp_geometry`, the Megatron attention on
    this rank's shards (:func:`_attn_block_train_tp`), whose output is
    reduced over ``model`` unless ``reduce`` is False (then the caller
    reduces it); otherwise :func:`attn_block_prefill` on whole weights."""
    geo = tp_geometry(cfg, par.tp) if explicit(par) else None
    if geo is None:
        return attn_block_prefill(cfg, p, x, positions, causal=causal,
                                  site=site)
    y, k, v = _attn_block_train_tp(cfg, p, x, positions, par, geo, causal,
                                   site)
    return (par.reduce_from_model(y) if reduce else y), k, v


def serving_geometry(cfg: ModelConfig, par: Optional[ParallelCtx]):
    """The explicit-TP geometry a serving mesh runs the GQA attention at
    (None: no ``model`` axis > 1); raises where the heads do not split
    (the reference's GSPMD fallback has no explicit counterpart)."""
    if not explicit(par):
        return None
    geo = tp_geometry(cfg, par.tp)
    if geo is None:
        raise NotImplementedError(f"{cfg.name}: {cfg.n_heads} heads over "
                                  f"{cfg.n_kv_heads} KV heads have no "
                                  f"explicit split over model={par.tp}")
    return geo


def serving_attn_prefill(cfg: ModelConfig, p, x, positions,
                         par: Optional[ParallelCtx]):
    """A GQA block's prefill attention and the K / V its pools take: on
    one device :func:`attn_block_prefill`; over a serving mesh the
    Megatron attention on this rank's heads (reduced over ``model``), its
    K / V gathered over ``model`` where the block split them (every page
    shard stores every KV head).  Returns (out, k, v)."""
    geo = serving_geometry(cfg, par)
    a, k, v = attn_block_train(cfg, p, x, positions, par=par)
    if geo is not None and kv_sharded(cfg, geo):
        k, v = par.gather_model(k, 2), par.gather_model(v, 2)
    return a, k, v


def attn_block_decode(cfg: ModelConfig, p, x, pos, k_pool, v_pool,
                      ctx: PageCtx, par: Optional[ParallelCtx] = None):
    """x [B,1,d], pos [B] -> [B,1,d]; writes this token's K/V in place.
    Over a serving mesh (``par``): q, k, v from this rank's head shards,
    gathered over ``model``; the paged attention over this rank's stripe;
    the output projection over its heads, reduced over ``model``."""
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    dh = cfg.resolved_head_dim
    geo = serving_geometry(cfg, par)
    if geo is not None:
        q = par.gather_model(q, 2)
        if kv_sharded(cfg, geo):
            k, v = par.gather_model(k, 2), par.gather_model(v, 2)
    o = paged_attn_op(q[:, 0], k[:, 0], v[:, 0], k_pool, v_pool, ctx,
                      scale=dh ** -0.5, par=par)
    B = o.shape[0]
    if geo is not None:
        H_loc = geo[1]
        o = o[:, par.model_rank * H_loc:(par.model_rank + 1) * H_loc]
    y = o.reshape(B, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    if geo is not None:
        y = par.reduce_from_model(y)
    return y[:, None, :]


def ffn_tp(cfg: ModelConfig, par: Optional[ParallelCtx]) -> bool:
    """Whether the SwiGLU runs tensor-parallel under ``par``."""
    return explicit(par) and cfg.d_ff % par.tp == 0


def ffn_block(cfg: ModelConfig, p, x, par: Optional[ParallelCtx] = None,
              reduce=True):
    """SwiGLU; under :func:`ffn_tp` the reference's explicit TP SwiGLU on
    this rank's shards (w_gate / w_up column-parallel, w_down row-parallel,
    x by copy-to-model), reduced over ``model`` unless ``reduce`` is
    False."""
    if not ffn_tp(cfg, par):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    y = swiglu(par.copy_to_model(x), p["w_gate"], p["w_up"], p["w_down"])
    return par.reduce_from_model(y) if reduce else y


def layer_ffn(cfg: ModelConfig, lp, x, par: Optional[ParallelCtx] = None):
    """The layer's serving FFN on normed rows: routed experts or SwiGLU;
    over a serving mesh (``par``) the serving MoE or the TP SwiGLU."""
    if cfg.moe is not None:
        return moe_block(cfg, lp["moe"], x, par)[0]
    return ffn_block(cfg, lp["mlp"], x, par)


# ------------------------------------------------------------------ stack

def _attn_train(cfg: ModelConfig, lp, x, positions, par=None, reduce=True):
    """The layer's attention block (MLA or GQA) on the residual stream x;
    unreduced with ``reduce`` False (see :func:`attn_block_train`)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        return mla_block_train(cfg, lp["attn"], h, positions)[0]
    return attn_block_train(cfg, lp["attn"], h, positions, par=par,
                            reduce=reduce)[0]


def _ffn_train(cfg: ModelConfig, lp, x, par=None):
    """The layer's FFN block on the residual stream x, before its
    reduces: (partial outputs, aux), the routed experts' load-balance loss
    or, for SwiGLU, 0 (see :func:`_merge`)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        return moe_parts(cfg, lp["moe"], h, par)
    return ([ffn_block(cfg, lp["mlp"], h, par, reduce=False)],
            torch.zeros((), dtype=torch.float32, device=x.device))


def _merge(cfg: ModelConfig, par, parts):
    """The FFN block's output from :func:`_ffn_train`'s partial outputs
    (:func:`merge_parts`), reduced over ``model`` where the block ran
    tensor- or expert-parallel."""
    return merge_parts(par, parts, explicit(par) and (
        cfg.moe is not None or ffn_tp(cfg, par)))


def _attn_reduce(cfg: ModelConfig, par, y):
    """The attention block's output from its partial (GQA under an
    explicit geometry; MLA runs whole)."""
    if cfg.mla is None and explicit(par) and tp_geometry(cfg, par.tp):
        return par.reduce_from_model(y)
    return y


def _layer_train(cfg: ModelConfig, lp, x, positions, par=None):
    x = x + _attn_train(cfg, lp, x, positions, par)
    parts, aux = _ffn_train(cfg, lp, x, par)
    return x + _merge(cfg, par, parts), aux


def decoder_stack_train(cfg: ModelConfig, params: Sequence[Dict[str, object]],
                        x, positions, *, remat=True,
                        par: Optional[ParallelCtx] = None):
    """The stack's training forward (the reference's ``_layer_train`` per
    layer: MLA or GQA attention, routed experts or SwiGLU) over per-layer
    weight trees (:meth:`DecoderParams.train_layers`).  Returns (x, aux):
    the MoE load-balance losses summed over the layers (0 for dense
    layers), as the reference.

    remat: False / "none" keeps every activation; True / "block" recomputes
    each layer in the backward from its input (``torch.utils.checkpoint``,
    non-reentrant), its reduces over ``model`` included; "save_collectives"
    checkpoints the attention block and the FFN block separately, each
    checkpoint ending before the block's reduce-from-model, whose output
    is kept: the recompute re-runs only local math (the reference's
    ``save_only_these_names("tp_psum")``).  Over ``model`` a layer and step
    then runs 4 all-reduces (2 reduces forward, 2 copy-to-model
    backward), and 6 under "block", whose recompute reduces again.  On one
    device there is no all-reduce, and each block is recomputed with
    "block"'s arithmetic.  A MoE layer's recompute routes its tokens as
    its forward did: the capacity follows the forward's token count,
    which it sees again.  ``par``: the ranks the forward runs over (the
    MoE load-balance loss's data group, the ``model`` axis); None on one
    rank.
    """
    layer_remat(remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params:
        if remat == "save_collectives":
            x = x + _attn_reduce(cfg, par, ckpt(_attn_train, cfg, lp, x,
                                                positions, par, False))
            parts, a = ckpt(_ffn_train, cfg, lp, x, par)
            x = x + _merge(cfg, par, parts)
        elif remat in (True, "block"):
            x, a = ckpt(_layer_train, cfg, lp, x, positions, par)
        else:
            x, a = _layer_train(cfg, lp, x, positions, par)
        aux = aux + a
    return x, aux


def decoder_stack_prefill(cfg: ModelConfig, params: DecoderParams, x,
                          positions, pools, ctx: PageCtx, prefix_kv=None,
                          tok_offset: int = 0,
                          par: Optional[ParallelCtx] = None):
    """pools: (k_pool [L,...], v_pool [L,...]), written in place.

    ``prefix_kv``: layer-stacked cached-prefix K/V ([L, B, P, Hkv, dh]
    pair) for suffix-only prefill; each layer attends over its slice, and
    ``tok_offset`` (= P) keeps the cached pages out of the pool write.
    ``par``: a serving mesh (module docstring; no cached prefix there)."""
    if on_mesh(par):
        if prefix_kv is not None or tok_offset:
            raise NotImplementedError("a cached prefix has no mesh path")
        return _stack_prefill_mesh(cfg, params, x, positions, pools, ctx,
                                   par)
    if cfg.moe is not None or cfg.mla is not None:
        return _stack_prefill_whole(cfg, params, x, positions, pools, ctx)
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        q, k, v = _row_blocks(functools.partial(_attn_in, cfg, lp), x,
                              positions)
        pkv = None if prefix_kv is None else (prefix_kv[0][l],
                                              prefix_kv[1][l])
        o = prefill_attention(q, k, v, pkv)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx,
                         tok_offset=tok_offset)
        x = _row_blocks(functools.partial(_attn_out_ffn, cfg, lp), x, o)
    return x, pools


def _stack_prefill_whole(cfg: ModelConfig, params: DecoderParams, x,
                         positions, pools, ctx: PageCtx):
    """The MoE / MLA prefill: each layer over the whole prompt (MoE
    capacity is a function of the forward's length, so no row blocks and
    no prefix cache, as the reference)."""
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            a, lat = mla_block_prefill(cfg, lp["attn"], h, positions)
            k, v = lat["k"], lat["v"]
        else:
            a, k, v = attn_block_prefill(cfg, lp["attn"], h, positions)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx)
        x = x + a
        x = x + layer_ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x, pools


def _stack_prefill_mesh(cfg: ModelConfig, params: DecoderParams, x,
                        positions, pools, ctx: PageCtx, par: ParallelCtx):
    """Prefill over a serving mesh: each layer over the whole prompt of
    this rank's rows (the reference's ``attn_block_train`` under a mesh:
    the Megatron attention, or MLA over this rank's heads), the K / V (or
    latents) written into this rank's stripe, the serving FFN."""
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            a, lat = mla_block_prefill(cfg, lp["attn"], h, positions, par)
            k, v = lat["k"], lat["v"]
        else:
            a, k, v = serving_attn_prefill(cfg, lp["attn"], h, positions,
                                           par)
        prefill_write_op(k, v, k_pools[l], v_pools[l], ctx, par=par)
        x = x + a
        x = x + layer_ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), par)
    return x, pools


def decoder_stack_decode(cfg: ModelConfig, params: DecoderParams, x, pos,
                         pools, ctx: PageCtx,
                         par: Optional[ParallelCtx] = None):
    """One decode token per row through every layer; ``par``: a serving
    mesh (module docstring)."""
    k_pools, v_pools = pools
    for l in range(params.n_layers):
        lp = params.layer(l)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        # Staged pages arrive layer-stacked; each layer reads its slice.
        if cfg.mla is not None:
            a = mla_block_decode(cfg, lp["attn"], h, pos, k_pools[l],
                                 v_pools[l], ctx.stage_at(l), par)
        else:
            a = attn_block_decode(cfg, lp["attn"], h, pos, k_pools[l],
                                  v_pools[l], ctx.stage_at(l), par)
        x = x + a
        x = x + layer_ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps), par)
    return x, pools
