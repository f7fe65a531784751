"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64.  A single shared transformer block (attention +
MLP, weights reused) is invoked every 6 mamba layers; its KV cache is paged
through Mosaic (DESIGN.md §4).  The published model applies per-invocation
LoRA deltas to the shared block; we share weights exactly (disclosed).
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid=HybridConfig(period=6, n_shared_blocks=1),
    source="arXiv:2411.15242; hf",
)


def smoke_config():
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, head_dim=16, max_seq_len=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        hybrid=HybridConfig(period=2, n_shared_blocks=1),
    )
