"""Parameter init helpers (the distributions of the reference's ``models/common.py``).

The reference draws from ``jax.random``; the port draws the same
distributions from an explicit ``torch.Generator``, so the numbers differ
from the reference's for the same seed.  Tests that compare the two
packages load the reference's weights through :mod:`repro_torch.bridge`
instead of re-drawing them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def empty_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, frozen weight (filled by ``init_`` or
    ``load_state_dict``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(t: torch.Tensor, in_axis: int,
                generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place: truncated-normal fan-in init (LeCun-style).

    Drawn in float32 (as the reference stores it) and cast once into
    ``t``'s dtype.
    """
    shape: Sequence[int] = t.shape
    fan_in = shape[in_axis] if len(shape) else 1
    scale = 1.0 / max(1.0, fan_in) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(scale))
    return t


def embed_init_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 1) · 0.02, drawn in float32."""
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(0.02))
    return t
