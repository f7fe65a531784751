"""Architecture registry of the PyTorch port: ``--arch <id>`` → ModelConfig.

Lists only the architectures the port serves.  ``base.py`` and each
architecture module are copies of the reference package's, so both packages
size pools and models identically.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, PoolGeometry

ARCHS: Dict[str, str] = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).smoke_config()


__all__ = ["ARCHS", "list_archs", "get_config", "get_smoke_config",
           "ModelConfig", "PoolGeometry"]
