"""Model code of the port: layers, paged KV, the dense decoder stack, LM."""

from repro_torch.models.lm import LM
from repro_torch.models.transformer import PageCtx

__all__ = ["LM", "PageCtx"]
