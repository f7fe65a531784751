"""qwen2.5-3b — dense, GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, max_seq_len=512,
    )
