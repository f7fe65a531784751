"""Mosaic core: the paper's contribution as a composable library.

Components (paper §2):
  * :class:`~repro.core.pagepool.PagePool`       — physical pages/frames
  * :class:`~repro.core.cocoa.CoCoA`             — contiguity-conserving allocation
  * :class:`~repro.core.coalescer.InPlaceCoalescer` — metadata-only promotion
  * :class:`~repro.core.compaction.CAC`          — contiguity-aware compaction
  * :class:`~repro.core.manager.MosaicManager`   — facade wiring the above
  * :class:`~repro.core.baseline_mmu.BaselineMMU`— GPU-MMU baseline (Power et al.)
  * :mod:`~repro.core.tlb_sim`                   — paper-faithful TLB timing model
  * :mod:`~repro.core.demand_paging`             — host↔HBM base-page transfers
"""

from repro_torch.core.pagepool import PagePool, PoolConfig
from repro_torch.core.page_table import PageTable, pack_batch_tables, UNMAPPED
from repro_torch.core.cocoa import CoCoA, OutOfMemory
from repro_torch.core.coalescer import InPlaceCoalescer
from repro_torch.core.compaction import CAC, CompactionPlan, CopyOp
from repro_torch.core.manager import MosaicManager, pages_for_tokens
from repro_torch.core.baseline_mmu import BaselineMMU
from repro_torch.core.demand_paging import (
    FaultBatch,
    LinkModel,
    ResidencyTracker,
    contiguous_runs,
)

MANAGERS = {"mosaic": MosaicManager, "gpu-mmu": BaselineMMU}


def make_manager(kind: str, config: PoolConfig, *, link=None,
                 page_bytes: int = 0):
    return MANAGERS[kind](config, link=link, page_bytes=page_bytes)


__all__ = [
    "PagePool", "PoolConfig", "PageTable", "pack_batch_tables", "UNMAPPED",
    "CoCoA", "OutOfMemory", "InPlaceCoalescer", "CAC", "CompactionPlan",
    "CopyOp", "MosaicManager", "BaselineMMU", "MANAGERS", "make_manager",
    "LinkModel", "ResidencyTracker", "FaultBatch", "contiguous_runs",
    "pages_for_tokens",
]
