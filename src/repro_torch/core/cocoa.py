"""CoCoA — Contiguity-Conserving Allocation (paper §2; DESIGN.md §1).

The first of Mosaic's three cooperating mechanisms (CoCoA allocates,
the :mod:`In-Place Coalescer <repro.core.coalescer>` promotes, :mod:`CAC
<repro.core.compaction>` repairs): the *allocation-time* half of the
paper's argument that contiguity is nearly free to **conserve** if you
never break it, whereas recovering it later costs data migration.

Allocation policy:

* **En-masse allocations** (a prefill allocating a whole sequence's KV at
  once — the paper's key observation about GPGPU allocation behaviour) take
  whole free frames so that virtually-contiguous base pages are physically
  contiguous *and aligned* within large-page frames.  Every fully covered
  frame is immediately coalescible with zero copies.
* **Soft guarantee**: a large-page frame only ever holds base pages of a
  single owner.  Under memory pressure we fall back to free slots in
  *this owner's* partial frames (conserving the guarantee) before failing;
  the caller then runs CAC compaction or evicts.
* **Appends** (decode-time growth, one page per ``page_tokens`` tokens) fill
  the owner's active frame slot-by-slot in alignment order, so a frame
  coalesces the moment its last slot fills.

Alignment invariant maintained throughout: a page mapped at virtual page
number ``vpn`` is placed at slot ``vpn % frame_pages`` of its frame whenever
possible, which is exactly the In-Place Coalescer's promotion condition.

What conserved contiguity buys downstream (the claims the benches pin):

* *translation reach* — coalesced frames translate as large pages in the
  TLB-timing simulator (:mod:`repro.core.tlb_sim`, paper Figs. 1/5/6) and
  take the frame-granular fast path of the dual-granularity Pallas
  paged-attention kernel (DESIGN.md §4);
* *transfer merging* — physically-contiguous base pages merge into single
  DMA descriptors on the host↔device link (one setup cost per run, not
  per page), which is why the serving engine's swap/fault batches and the
  prefix cache's admission fault-ins are cheap under Mosaic
  (:class:`repro.core.demand_paging.FaultBatch`, DESIGN.md §6/§8);
* *whole-frame return* — the soft guarantee means a finished sequence
  hands back intact frames, so multi-tenant churn does not splinter the
  pool (the ``memory_bloat``/fragmentation comparisons vs ``gpu-mmu``).

``OutOfMemory`` raised here is a *scheduling* signal, not a failure: the
serving engine responds with CAC compaction, then cost-aware preemption
to the host tier (DESIGN.md §6).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.coalescer import InPlaceCoalescer
from repro_torch.core.page_table import UNMAPPED, PageTable
from repro_torch.core.pagepool import FREE, PagePool


class OutOfMemory(Exception):
    """Pool cannot satisfy the request; caller should compact or evict."""


class CoCoA:
    def __init__(self, pool: PagePool, coalescer: Optional[InPlaceCoalescer] = None):
        self.pool = pool
        self.coalescer = coalescer or InPlaceCoalescer(pool)
        # owner -> active (tail) frame being filled by appends, if any.
        self._active_frame: Dict[int, int] = {}
        # owner -> frames owned with ≥1 free slot (pressure fallback pool).
        self._partial_frames: Dict[int, List[int]] = {}

    # -- internal helpers --------------------------------------------------------

    def _note_partial(self, owner: int, frame: int) -> None:
        fp = self.pool.config.frame_pages
        lst = self._partial_frames.setdefault(owner, [])
        if self.pool.frame_used[frame] < fp and frame not in lst:
            lst.append(frame)

    def _unnote_if_full_or_released(self, owner: int, frame: int) -> None:
        lst = self._partial_frames.get(owner, [])
        fp = self.pool.config.frame_pages
        if frame in lst and (
            self.pool.frame_used[frame] == fp or self.pool.frame_owner[frame] == FREE
        ):
            lst.remove(frame)

    def _alloc_slot(
        self, owner: int, table: PageTable, want_slot: int
    ) -> Tuple[int, bool]:
        """Allocate one page for the owner's tail, preferring alignment.

        Returns (ppn, aligned) where ``aligned`` is True when the page landed
        at its alignment-preserving slot in a frame whose earlier slots hold
        the preceding vpns (i.e. the frame can still coalesce).
        """
        pool = self.pool
        # 1. Active frame with the aligned slot free → contiguity conserved.
        af = self._active_frame.get(owner)
        if af is not None and pool.frame_owner[af] == owner:
            ppn = pool.page_of(af, want_slot)
            if not pool.page_allocated[ppn]:
                pool.alloc_page(af, want_slot)
                self._unnote_if_full_or_released(owner, af)
                return ppn, True
        # 2. Start a new frame (only makes sense at slot 0 for alignment).
        if want_slot == 0:
            f = pool.take_free_frame(owner)
            if f is not None:
                self._active_frame[owner] = f
                pool.alloc_page(f, 0)
                self._note_partial(owner, f)
                self._unnote_if_full_or_released(owner, f)
                return pool.page_of(f, 0), True
        elif af is None or pool.frame_owner[af] != owner:
            # Lost our active frame mid-sequence (restore path): try a fresh
            # frame and keep alignment by landing at want_slot.
            f = pool.take_free_frame(owner)
            if f is not None:
                self._active_frame[owner] = f
                pool.alloc_page(f, want_slot)
                self._note_partial(owner, f)
                self._unnote_if_full_or_released(owner, f)
                return pool.page_of(f, want_slot), True
        # 3. Pressure fallback: any free slot in this owner's partial frames
        #    (soft guarantee conserved; contiguity sacrificed).
        for f in list(self._partial_frames.get(owner, [])):
            if pool.frame_owner[f] != owner:
                self._partial_frames[owner].remove(f)
                continue
            slots = pool.free_slots(f)
            if slots:
                # Prefer the aligned slot if free, else any.
                s = want_slot if want_slot in slots else slots[0]
                pool.alloc_page(f, s)
                self._unnote_if_full_or_released(owner, f)
                return pool.page_of(f, s), s == want_slot
        # 4. Last resort even at slot != 0: brand-new frame, aligned slot.
        f = pool.take_free_frame(owner)
        if f is not None:
            self._active_frame[owner] = f
            pool.alloc_page(f, want_slot)
            self._note_partial(owner, f)
            self._unnote_if_full_or_released(owner, f)
            return pool.page_of(f, want_slot), True
        raise OutOfMemory(
            f"owner {owner}: no free frame and no partial-frame slot "
            f"(pool occupancy {pool.occupancy():.1%})"
        )

    # -- public API ---------------------------------------------------------------

    def alloc_en_masse(self, owner: int, table: PageTable, n_pages: int) -> List[int]:
        """Allocate ``n_pages`` new tail pages at once (prefill path).

        Fully covered virtual frames are coalesced immediately (paper steps
        5–6: CoCoA sends the frame list to the In-Place Coalescer).
        """
        fp = self.pool.config.frame_pages
        vpns: List[int] = []
        touched_vframes = set()
        for _ in range(n_pages):
            vpn = table.num_pages
            ppn, _ = self._alloc_slot(owner, table, vpn % fp)
            table.append(ppn)
            vpns.append(vpn)
            touched_vframes.add(table.vframe_of(vpn))
        self.coalescer.coalesce_all(table, touched_vframes)
        return vpns

    def append_page(self, owner: int, table: PageTable) -> int:
        """Allocate one tail page (decode growth path)."""
        fp = self.pool.config.frame_pages
        vpn = table.num_pages
        ppn, _ = self._alloc_slot(owner, table, vpn % fp)
        table.append(ppn)
        self.coalescer.maybe_coalesce(table, table.vframe_of(vpn))
        return vpn

    def forget_owner(self, owner: int) -> None:
        self._active_frame.pop(owner, None)
        self._partial_frames.pop(owner, None)

    def partial_frames(self, owner: int) -> List[int]:
        pool = self.pool
        return [
            f
            for f in self._partial_frames.get(owner, [])
            if pool.frame_owner[f] == owner
            and pool.frame_used[f] < pool.config.frame_pages
        ]
