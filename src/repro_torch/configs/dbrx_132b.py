"""dbrx-132b — fine-grained MoE, GQA.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752(expert) vocab=100352, 16 experts top-4.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
    source="hf:databricks/dbrx-base; unverified",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
        vocab_size=512, max_seq_len=512,
        moe=dataclasses.replace(CONFIG.moe, n_experts=4, top_k=2, d_expert=96,
                                capacity_factor=4.0),
    )
