"""Architecture registry of the PyTorch port: ``--arch <id>`` → ModelConfig.

Lists the reference's ten architectures, in its order.  ``base.py`` and each
architecture module are copies of the reference package's, so both packages
size pools and models identically.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, PoolGeometry

ARCHS: Dict[str, str] = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).smoke_config()


__all__ = ["ARCHS", "list_archs", "get_config", "get_smoke_config",
           "ModelConfig", "PoolGeometry"]
