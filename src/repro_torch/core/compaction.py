"""CAC — Contiguity-Aware Compaction (paper §2, memory deallocation path).

The third of Mosaic's mechanisms: where :mod:`CoCoA <repro.core.cocoa>`
*conserves* contiguity and the :mod:`coalescer <repro.core.coalescer>`
*exploits* it for free, CAC *repairs* it with bounded copies when
deallocation-driven fragmentation finally breaks it — the only point in
the whole design where data actually moves on-device.

When deallocation leaves large pages with high internal fragmentation, the
runtime part of CAC (this module) (1) splinters those large pages back to
base pages (metadata-only, via the In-Place Coalescer) and (2) plans a
compaction: live base pages from multiple splintered frames are migrated
into as few frames as possible; emptied frames return to CoCoA's free pool.

The *data movement* is expressed as a list of :class:`CopyOp`; the serving
engine executes it on-device with the ``page_compact`` Pallas kernel (the
"hardware portion").  The paper models compaction conservatively as a
whole-GPU stall; our TLB-timing simulator (:mod:`repro.core.tlb_sim`) keeps
that conservative model, while the real engine overlaps the batched copy
between decode steps.

The plan is computed greedily per owner (frames hold one owner's pages only
— CoCoA's soft guarantee — so compaction never mixes protection domains):
source frames are the most-fragmented, destinations are the least-fragmented
partial frames; pages move src→dst until sources empty.

Ordering contract with the engine (the subtle part): tables are rewritten
at *plan* time, payloads move at *execution* time — so the engine lands
pending ``CopyOp``s (``_run_compaction``) before anything reads or
gathers through the rewritten tables: before prefill, before decode,
before preemption/parking gathers (DESIGN.md §6/§8).  Residency rides
along via ``ResidencyTracker.on_copy`` — a host-backed (non-resident)
page stays host-backed at its new physical location, which is what lets
compaction run safely under the host tier's demand paging and the
prefix cache's demoted admission pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.coalescer import InPlaceCoalescer
from repro_torch.core.page_table import PageTable
from repro_torch.core.pagepool import FREE, PagePool


@dataclasses.dataclass(frozen=True)
class CopyOp:
    """Move one base page's payload ``src_ppn`` → ``dst_ppn`` on device."""

    src_ppn: int
    dst_ppn: int


@dataclasses.dataclass
class CompactionPlan:
    copies: List[CopyOp]
    freed_frames: List[int]

    @property
    def bytes_moved_pages(self) -> int:
        return len(self.copies)


class CAC:
    def __init__(self, pool: PagePool, coalescer: InPlaceCoalescer):
        self.pool = pool
        self.coalescer = coalescer

    # -- fragmentation scan -------------------------------------------------------

    def fragmented_frames(self, owner: int) -> List[int]:
        """Owner's frames whose unallocated fraction exceeds the threshold."""
        pool = self.pool
        thr = pool.config.compact_threshold
        out = []
        for f in range(pool.config.num_frames):
            if pool.frame_owner[f] == owner and 0 < pool.frame_used[f]:
                if pool.frame_frag(f) > thr:
                    out.append(f)
        return out

    # -- splinter on partial dealloc (paper step 8) ---------------------------------

    def splinter_for_dealloc(self, table: PageTable, vpns: Sequence[int]) -> None:
        for vf in {table.vframe_of(v) for v in vpns}:
            self.coalescer.splinter(table, vf)

    # -- compaction (paper step 9) ---------------------------------------------------

    def compact_owner(
        self, owner: int, table: PageTable, rmap: Dict[int, Tuple[int, int]]
    ) -> CompactionPlan:
        """Compact one owner's fragmented frames.

        ``rmap`` maps ppn -> (owner, vpn) and is updated in place, as is the
        owner's page table and the pool's physical state.
        """
        pool = self.pool
        fp = pool.config.frame_pages
        srcs = self.fragmented_frames(owner)
        # Order: emptiest frames are drained first (fewest copies per freed
        # frame — the greedy that maximizes frames freed per byte moved).
        srcs.sort(key=lambda f: pool.frame_used[f])
        copies: List[CopyOp] = []
        freed: List[int] = []
        if not srcs:
            return CompactionPlan(copies, freed)
        # Destinations: fullest-first partial frames not selected as sources.
        dsts = [
            f
            for f in range(pool.config.num_frames)
            if pool.frame_owner[f] == owner
            and 0 < pool.frame_used[f] < fp
            and f not in srcs
        ]
        dsts.sort(key=lambda f: -pool.frame_used[f])
        # Also allow back-filling the fullest source frames with pages drained
        # from the emptiest ones (classic two-pointer compaction).
        dsts = dsts + list(reversed(srcs))

        def dst_slot() -> Tuple[int, int]:
            while dsts:
                f = dsts[0]
                if pool.frame_owner[f] == owner and pool.frame_used[f] < fp:
                    free = pool.free_slots(f)
                    if free:
                        return f, free[0]
                dsts.pop(0)
            return -1, -1

        for src in srcs:
            if pool.frame_owner[src] != owner:
                continue  # already drained & released
            base = src * fp
            for s in range(fp):
                ppn = base + s
                if not pool.page_allocated[ppn]:
                    continue
                df, dslot = dst_slot()
                if df == -1 or df == src:
                    break  # nowhere better to move remaining pages
                # Splinter the destination frame if it was large (it cannot
                # be: coalesced frames are full) — assert instead.
                assert not pool.frame_coalesced[df]
                o, vpn = rmap.pop(ppn)
                assert o == owner, "CAC crossed a protection domain"
                dppn = pool.page_of(df, dslot)
                pool.alloc_page(df, dslot)
                pool.free_page(ppn)  # releases src frame when it empties
                table.set(vpn, dppn)
                rmap[dppn] = (owner, vpn)
                copies.append(CopyOp(ppn, dppn))
                pool.stats["compaction_copies"] += 1
                # A destination frame that just became full+contiguous could
                # re-coalesce; compaction does not guarantee alignment, so we
                # only flip the bit when the coalescer's check passes.
                self.coalescer.maybe_coalesce(table, table.vframe_of(vpn))
            if pool.frame_owner[src] == FREE:
                freed.append(src)
        return CompactionPlan(copies, freed)
