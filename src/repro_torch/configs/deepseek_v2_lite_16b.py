"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention.

[arXiv:2405.04434; hf]  27L d_model=2048 16H d_ff=1408(expert) vocab=102400,
MLA kv_lora=512, 64 routed experts top-6 + 2 shared, first layer dense FFN
(d_ff dense = 10944 per the HF config).

Assignment-line note (DESIGN.md §4): the line reads "2 shared+160 routed";
160 routed is DeepSeek-V2-full.  We follow the primary spec "MoE 64e top-6"
= V2-Lite: 64 routed + 2 shared.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                      # dense-FFN layers (layer 0)
    vocab_size=102400,
    head_dim=192,                    # qk_nope 128 + qk_rope 64
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434; hf",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, head_dim=24, max_seq_len=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32, n_shared=1,
                      first_dense=1, capacity_factor=4.0),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )
