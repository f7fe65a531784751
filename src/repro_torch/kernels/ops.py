"""Public kernel entry points and their launch counters.

Counterpart of the reference's ``kernels/ops.py``.  The reference picks its
path with ``use_pallas``; here the tensors' device picks it: CPU tensors run
each kernel's plain version, CUDA tensors launch the hand-written kernel
(or raise).  :func:`launch_counts` reads every serving kernel's launch
counter, :func:`flash_site_counts` the flash kernel's by call site,
:func:`train_launch_counts` the training kernels' (the flash forward with
its log-sum-exp, the flash backward and the SSD-scan backward; the SSD
scan's training forward is the serving call and counts under
``ssd_scan``) and :func:`train_site_counts` the training flash kernels'
by call site.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_lse,
)
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
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

KERNELS = ("paged_attention.page", "paged_attention.frame",
           "paged_attention.fused", "page_gather", "page_scatter",
           "page_compact", "flash_attention", "ssd_scan")


def paged_attention_dual(q, pool_k, pool_v, frame_tables, frame_ntok,
                         page_tables, page_ntok, *, frame_pages: int,
                         scale: float):
    """Dual-granularity paged attention over one pool.

    Coalesced frames go down the frame path, splintered pages down the page
    path, and the partials are flash-combined.  Returns normalized
    [B, H, dh_v] float32.
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
        "flash_attention": flash_attention.launches,
        "ssd_scan": ssd_scan.launches,
    }


def flash_site_counts() -> Dict[str, int]:
    """Flash-attention launches by call site (``flash_attention.<site>``),
    since the last :func:`reset_launch_counts`; each is also in
    ``launch_counts()["flash_attention"]``."""
    return {f"flash_attention.{k}": n
            for k, n in flash_attention.site_launches.items()}


def train_launch_counts() -> Dict[str, int]:
    """Training kernels' launches since the last :func:`reset_launch_counts`:
    the flash forward with its log-sum-exp (``flash_attention.train``), the
    flash backward (``flash_attention_bwd``) and the SSD-scan backward
    (``ssd_scan_bwd``), each one per call whatever its launches."""
    return {"flash_attention.train": flash_attention_lse.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "ssd_scan_bwd": ssd_scan_bwd.launches}


def train_site_counts() -> Dict[str, int]:
    """The training flash kernels' launches by call site
    (``flash_attention.train.<site>``, ``flash_attention_bwd.<site>``) since
    the last :func:`reset_launch_counts`; each is also in
    ``train_launch_counts()``'s entry of its kernel."""
    return {**{f"flash_attention.train.{k}": n
               for k, n in flash_attention_lse.site_launches.items()},
            **{f"flash_attention_bwd.{k}": n
               for k, n in flash_attention_bwd.site_launches.items()}}


def reset_launch_counts() -> None:
    paged_attention_kernel.page_launches = 0
    paged_attention_kernel.frame_launches = 0
    fused_paged_attention_kernel.fused_launches = 0
    page_gather.launches = 0
    page_scatter.launches = 0
    page_compact.launches = 0
    flash_attention.launches = 0
    flash_attention.site_launches = dict.fromkeys(
        flash_attention.site_launches, 0)
    ssd_scan.launches = 0
    flash_attention_lse.launches = 0
    flash_attention_bwd.launches = 0
    for fn in (flash_attention_lse, flash_attention_bwd):
        fn.site_launches = dict.fromkeys(fn.site_launches, 0)
    ssd_scan_bwd.launches = 0


__all__ = ["KERNELS", "paged_attention_kernel", "paged_attention_dual",
           "fused_paged_attention_kernel",
           "combine_granularities", "page_gather", "page_scatter",
           "page_compact", "flash_attention", "ssd_scan", "ssd_scan_bwd",
           "launch_counts",
           "flash_attention_lse", "flash_attention_bwd", "flash_site_counts",
           "train_launch_counts", "train_site_counts",
           "reset_launch_counts"]
