"""In-Place Coalescer: metadata-only page-size promotion/demotion.

Paper §2 — the second of Mosaic's three mechanisms, and the one that
realizes the headline "application-transparent large pages without
migration" claim.  After :class:`~repro.core.cocoa.CoCoA` finishes an
allocation it hands the coalescer the list of touched large-page frames.
For each, the *runtime* part checks that (1) every base page in the frame
is allocated and (2) the base pages are contiguous in both virtual and
physical memory (and aligned).  If so, the *hardware* part updates the
page table so the frame is addressed as one large page — **no data
migration**.  Because CoCoA conserved contiguity at allocation time, the
check almost always passes and promotion is O(frame_pages) metadata.

The split mirrors the paper exactly:

* *runtime half* → :meth:`InPlaceCoalescer.maybe_coalesce` — the
  promotion-condition check (`PageTable.vframe_contiguous_aligned`);
* *hardware half* → the ``coalesced`` bit arrays on the page table and
  pool.  In the TLB-timing simulator (:mod:`repro.core.tlb_sim`) a set
  bit makes translation use the large-page TLB arrays (Fig. 1's reach
  benefit); on the model side the packed frame-table arrays the Pallas
  paged-attention kernel scalar-prefetches
  (:func:`repro.core.page_table.pack_batch_tables`) flip the kernel onto
  its contiguous-frame fast path — one index per frame, long DMAs
  (DESIGN.md §4).

Demotion (``splinter``) is the same operation in reverse and is what CAC
(:mod:`repro.core.compaction`) uses before migrating pages out of
fragmented frames: flipping the bit back re-enables base-page addressing
with, again, zero copies.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.core.page_table import PageTable
from repro_torch.core.pagepool import PagePool


class InPlaceCoalescer:
    def __init__(self, pool: PagePool):
        self.pool = pool

    def maybe_coalesce(self, table: PageTable, vf: int) -> bool:
        """Promote virtual frame ``vf`` to a large page if conditions hold."""
        if vf < len(table.coalesced) and table.coalesced[vf]:
            return True  # already large
        ok, pf = table.vframe_contiguous_aligned(vf)
        if not ok:
            return False
        table.coalesced[vf] = True
        self.pool.frame_coalesced[pf] = True
        self.pool.stats["coalesce_ops"] += 1
        return True

    def coalesce_all(self, table: PageTable, vframes: Iterable[int]) -> int:
        return sum(self.maybe_coalesce(table, vf) for vf in set(vframes))

    def splinter(self, table: PageTable, vf: int) -> bool:
        """Demote a large page back to base pages (metadata-only).

        Needed before any base page of the frame can be individually
        unmapped or migrated (paper §2, memory deallocation walkthrough).
        """
        if vf >= len(table.coalesced) or not table.coalesced[vf]:
            return False
        ok, pf = table.vframe_contiguous_aligned(vf)
        assert ok, "coalesced bit was set on a non-contiguous vframe"
        table.coalesced[vf] = False
        self.pool.frame_coalesced[pf] = False
        self.pool.stats["splinter_ops"] += 1
        return True
