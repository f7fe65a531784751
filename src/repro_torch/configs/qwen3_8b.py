"""qwen3-8b — dense, GQA kv=8, qk-norm.

[hf:Qwen/Qwen3-8B; hf]  36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16, max_seq_len=512,
    )
