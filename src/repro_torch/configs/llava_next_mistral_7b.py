"""llava-next-mistral-7b — VLM: Mistral-7B backbone, anyres patch stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The vision tower is a STUB:
``input_specs()`` provides precomputed patch embeddings (anyres tiling →
up to 2880 image tokens prepended to the prompt).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, frontend_tokens=16, max_seq_len=512,
    )
