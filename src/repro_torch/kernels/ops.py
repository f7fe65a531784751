"""Public kernel entry points and their launch counters.

Counterpart of the reference's ``kernels/ops.py``.  The reference picks its
path with ``use_pallas``; here the tensors' device picks it: CPU tensors run
each kernel's plain version, CUDA tensors launch the hand-written kernel
(or raise).  :func:`launch_counts` reads every kernel's launch counter.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.page_compact import (
    page_compact,
    page_gather,
    page_scatter,
)
from repro_torch.kernels.paged_attention import (
    combine_granularities,
    fused_paged_attention_kernel,
    paged_attention_kernel,
)

KERNELS = ("paged_attention.page", "paged_attention.frame",
           "paged_attention.fused", "page_gather", "page_scatter",
           "page_compact")


def paged_attention_dual(q, pool_k, pool_v, frame_tables, frame_ntok,
                         page_tables, page_ntok, *, frame_pages: int,
                         scale: float):
    """Dual-granularity paged attention over one pool.

    Coalesced frames go down the frame path, splintered pages down the page
    path, and the partials are flash-combined.  Returns normalized
    [B, H, dh] float32.
    """
    parts = [
        paged_attention_kernel(q, pool_k, pool_v, frame_tables, frame_ntok,
                               granularity="frame", frame_pages=frame_pages,
                               scale=scale),
        paged_attention_kernel(q, pool_k, pool_v, page_tables, page_ntok,
                               granularity="page", scale=scale),
    ]
    o, _m, l = combine_granularities(parts)
    return o / torch.clamp(l[..., None], min=1e-30)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {
        "paged_attention.page": paged_attention_kernel.page_launches,
        "paged_attention.frame": paged_attention_kernel.frame_launches,
        "paged_attention.fused": fused_paged_attention_kernel.fused_launches,
        "page_gather": page_gather.launches,
        "page_scatter": page_scatter.launches,
        "page_compact": page_compact.launches,
    }


def reset_launch_counts() -> None:
    paged_attention_kernel.page_launches = 0
    paged_attention_kernel.frame_launches = 0
    fused_paged_attention_kernel.fused_launches = 0
    page_gather.launches = 0
    page_scatter.launches = 0
    page_compact.launches = 0


__all__ = ["KERNELS", "paged_attention_kernel", "paged_attention_dual",
           "fused_paged_attention_kernel",
           "combine_granularities", "page_gather", "page_scatter",
           "page_compact", "launch_counts", "reset_launch_counts"]
