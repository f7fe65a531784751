"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio frontend stub).

[arXiv:2308.11596; hf]  24L(+24L dec) d_model=1024 16H d_ff=8192
vocab=256206.  The speech frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (DESIGN.md §4).
"""

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10000.0,
    encdec=EncDecConfig(enc_layers=24, dec_layers=24, source_len=4096),
    frontend="audio",
    source="arXiv:2308.11596; hf",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, max_seq_len=512,
        encdec=EncDecConfig(enc_layers=2, dec_layers=2, source_len=64),
    )
