"""phi3-mini-3.8b — dense, MHA (kv=32), RoPE SwiGLU.

[arXiv:2404.14219; unverified]  32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    source="arXiv:2404.14219; unverified",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, max_seq_len=512,
    )
