"""mamba2-1.3b — attention-free SSM (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128.  No KV cache; decode state is O(1) per layer — Mosaic's KV
path is N/A for this arch (DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=512, max_seq_len=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    )
