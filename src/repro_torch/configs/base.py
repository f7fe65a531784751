"""Config dataclasses for models, shapes, pools, and runs.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published configuration) and ``smoke_config()`` (a
reduced same-family variant for CPU tests).  ``repro.configs.get_config``
is the registry entry point used by ``--arch <id>`` everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # always-on shared experts
    capacity_factor: float = 1.25  # dispatch capacity (GShard-style)
    router_dtype: str = "float32"
    first_dense: int = 0           # leading layers that use a dense FFN


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention geometry."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0: no q compression (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD geometry."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: shared attention block every ``period`` layers."""

    period: int = 6                # insert shared block after every N ssm layers
    n_shared_blocks: int = 1       # distinct shared blocks cycled through


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 24
    dec_layers: int = 24
    cross_attention: bool = True
    source_len: int = 4096         # encoder memory length for decode shapes


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 524288
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[str] = None  # 'audio' | 'vision' modality stub
    frontend_tokens: int = 0        # prefix embeddings supplied by the stub
    dtype: str = "bfloat16"
    # Citation bookkeeping ([source; verified-tier] from the assignment).
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per = (
                d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
                + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                + d_in * d + d_in
            )
            return emb + L * per
        dh = self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_attn = (
                d * (m.kv_lora_rank + m.qk_rope_head_dim)       # kv down + rope k
                + (d * qdim if m.q_lora_rank == 0
                   else d * m.q_lora_rank + m.q_lora_rank * qdim)
                + m.kv_lora_rank * self.n_heads
                * (m.qk_nope_head_dim + m.v_head_dim)            # kv up
                + self.n_heads * m.v_head_dim * d                # out proj
            )
        else:
            kv = self.n_kv_heads * dh
            per_attn = d * (self.n_heads * dh + 2 * kv) + self.n_heads * dh * d
        if self.moe is not None:
            mo = self.moe
            dense_ffn = 3 * d * self.d_ff
            expert_ffn = 3 * d * mo.d_expert
            moe_layers = L - mo.first_dense
            per_ffn_moe = (
                (mo.n_experts + mo.n_shared) * expert_ffn + d * mo.n_experts
            )
            ffn_total = mo.first_dense * dense_ffn + moe_layers * per_ffn_moe
        else:
            ffn_total = L * 3 * d * self.d_ff
        total = emb + L * per_attn + ffn_total
        if self.encdec is not None:
            total += L * per_attn  # cross-attention in decoder layers
        if self.hybrid is not None:
            # Mamba2 backbone + shared attention block(s).
            s = self.ssm
            d_in = s.expand * d
            per_ssm = (
                d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
                + s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
                + d_in * d + d_in
            )
            shared = self.hybrid.n_shared_blocks * (per_attn + 3 * d * self.d_ff)
            return emb + L * per_ssm + shared
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters — 6·N_active·D for MoE rooflines."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d, L = self.d_model, self.n_layers
        inactive = (mo.n_experts - mo.top_k) * 3 * d * mo.d_expert
        return self.param_count() - (L - mo.first_dense) * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


# The four assigned LM shapes (identical across the 10 architectures).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524288, 1,   "decode"),
}


@dataclasses.dataclass(frozen=True)
class PoolGeometry:
    """Mosaic KV-pool geometry for serving (DESIGN.md §5)."""

    page_tokens: int = 64
    frame_pages: int = 16
    headroom: float = 1.25
    compact_threshold: float = 0.5

    def pages_for(self, seq_len: int, batch: int) -> int:
        per_seq = (seq_len + self.page_tokens - 1) // self.page_tokens
        raw = int(np.ceil(per_seq * batch * self.headroom))
        return ((raw + self.frame_pages - 1) // self.frame_pages) * self.frame_pages


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0            # 0: no gradient accumulation
    remat: str = "block"           # 'none' | 'block'
    zero1: bool = True             # shard optimizer state over data axis
    grad_compress: bool = False    # int8 all-reduce with error feedback
    parallelism: str = "megatron"  # 'megatron' (TP/EP over model axis) |
                                   # 'fsdp' (every axis data-parallel,
                                   #  ZeRO-3 weight streaming)
