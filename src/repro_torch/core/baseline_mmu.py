"""GPU-MMU baseline memory manager (Power et al., HPCA 2014 analogue).

The paper's baseline (its Fig. 2): base pages are allocated from a global
free list with **no frame awareness** — pages of different applications
interleave inside large-page frames, so fully-mapped frames virtually always
contain pages from multiple protection domains and can never be coalesced
without mass migration.  We reproduce that policy faithfully:

* allocation = pop the next free base page (lowest physical address first),
  regardless of frame ownership or alignment;
* no soft guarantee, no in-place coalescer (it would simply never fire —
  which we *measure* rather than assume: the coalescer check is run and its
  ~0% success rate is reported), no CAC.

Implements the same interface as :class:`repro.core.manager.MosaicManager`
so every engine/benchmark can flip between managers.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import page_table as pt
from repro_torch.core.compaction import CompactionPlan, CopyOp
from repro_torch.core.cocoa import OutOfMemory
from repro_torch.core.coalescer import InPlaceCoalescer
from repro_torch.core.demand_paging import (
    DEFAULT_PAGE_BYTES,
    LinkModel,
    ResidencyTracker,
)
from repro_torch.core.pagepool import FREE, PagePool, PoolConfig

_POOL_OWNER = 0  # PagePool sees one pseudo-owner; real owners tracked here.


class BaselineMMU:
    name = "gpu-mmu"

    def __init__(self, config: PoolConfig, *,
                 link: "LinkModel | None" = None, page_bytes: int = 0):
        self.config = config
        self.pool = PagePool(config)
        self.coalescer = InPlaceCoalescer(self.pool)
        # Same residency hooks as MosaicManager (DESIGN.md §6): demand
        # paging is manager-agnostic; only page *placement* differs, which
        # is exactly what the fault-DMA accounting measures.
        self.residency = ResidencyTracker(
            config.num_pages, page_bytes or DEFAULT_PAGE_BYTES, link)
        self.tables: Dict[int, pt.PageTable] = {}
        self.seq_tokens: Dict[int, int] = {}
        self.rmap: Dict[int, Tuple[int, int]] = {}
        self._free_pages: List[int] = list(range(config.num_pages))
        heapq.heapify(self._free_pages)
        # Which real owners have pages in each frame (paper Fig. 2 metric).
        self.frame_owner_sets: List[Set[int]] = [
            set() for _ in range(config.num_frames)
        ]
        # GPU-MMU is a 4KB-only design: it never *uses* large pages.  We
        # still count how often a frame happens to end up coalesceable, to
        # quantify the paper's "no opportunities without migration" claim.
        self.coalesce_opportunities = 0

    # -- owner lifecycle ---------------------------------------------------------

    def _table(self, owner: int) -> pt.PageTable:
        if owner not in self.tables:
            self.tables[owner] = pt.PageTable(self.config.frame_pages)
            self.seq_tokens[owner] = 0
        return self.tables[owner]

    def owners(self) -> List[int]:
        return sorted(self.tables)

    def table(self, owner: int) -> pt.PageTable:
        return self.tables[owner]

    # -- allocation ----------------------------------------------------------------

    def _alloc_page(self, owner: int) -> int:
        if not self._free_pages:
            raise OutOfMemory(f"baseline pool exhausted (owner {owner})")
        ppn = heapq.heappop(self._free_pages)
        f = self.pool.frame_of(ppn)
        if self.pool.frame_owner[f] == FREE:
            self.pool.take_specific_frame(f, _POOL_OWNER)
        self.pool.alloc_page(f, self.pool.slot_of(ppn))
        self.frame_owner_sets[f].add(owner)
        self.residency.mark_resident([ppn])
        return ppn

    def allocate_tokens(self, owner: int, n_tokens: int) -> List[int]:
        table = self._table(owner)
        have = (self.seq_tokens[owner] + self.config.page_tokens - 1) // self.config.page_tokens
        total = self.seq_tokens[owner] + n_tokens
        need = (total + self.config.page_tokens - 1) // self.config.page_tokens - have
        vpns = []
        for _ in range(need):
            ppn = self._alloc_page(owner)
            vpn = table.append(ppn)
            self.rmap[ppn] = (owner, vpn)
            vpns.append(vpn)
            # 4KB-only design: check (but never use) coalesceability, to
            # measure the paper's Fig. 2 claim that opportunities ~never arise.
            ok, _ = table.vframe_contiguous_aligned(table.vframe_of(vpn))
            self.coalesce_opportunities += int(ok)
        self.seq_tokens[owner] = total
        return vpns

    def append_tokens(self, owner: int, n_tokens: int = 1) -> List[int]:
        table = self._table(owner)
        new_vpns = []
        for _ in range(n_tokens):
            tok = self.seq_tokens[owner]
            if tok % self.config.page_tokens == 0:
                ppn = self._alloc_page(owner)
                vpn = table.append(ppn)
                self.rmap[ppn] = (owner, vpn)
                new_vpns.append(vpn)
                ok, _ = table.vframe_contiguous_aligned(table.vframe_of(vpn))
                self.coalesce_opportunities += int(ok)
            self.seq_tokens[owner] = tok + 1
        return new_vpns

    # -- deallocation -----------------------------------------------------------------

    def _free_ppn(self, owner: int, ppn: int) -> None:
        f = self.pool.frame_of(ppn)
        self.pool.free_page(ppn)  # releases the frame if it empties
        self.rmap.pop(ppn, None)
        self.residency.release([ppn])
        heapq.heappush(self._free_pages, ppn)
        owners_left = {
            self.rmap[p][0]
            for p in range(f * self.config.frame_pages,
                           (f + 1) * self.config.frame_pages)
            if p in self.rmap
        }
        self.frame_owner_sets[f] = owners_left

    def free_pages(self, owner: int, vpns: Sequence[int]) -> None:
        table = self.tables[owner]
        for vf in {table.vframe_of(v) for v in vpns}:
            self.coalescer.splinter(table, vf)
        for vpn in vpns:
            self._free_ppn(owner, table.unmap(vpn))

    def deallocate(self, owner: int) -> None:
        table = self.tables.pop(owner)
        for vf in range(table.num_vframes):
            self.coalescer.splinter(table, vf)
        for vpn in table.mapped_vpns():
            self._free_ppn(owner, table.unmap(vpn))
        self.seq_tokens.pop(owner, None)

    # -- compaction: the baseline has none ------------------------------------------------

    def compact(self, owner: int) -> CompactionPlan:
        return CompactionPlan([], [])

    def drain_copy_ops(self) -> List[CopyOp]:
        return []

    # -- kernel-facing views ----------------------------------------------------------------

    def pack(self, owners: Sequence[int], max_pages: int) -> Dict[str, np.ndarray]:
        packed = pt.pack_batch_tables(
            [self.tables[o] for o in owners], max_pages, self.config.frame_pages
        )
        packed["seq_tokens"] = np.asarray(
            [self.seq_tokens[o] for o in owners], dtype=np.int32
        )
        return packed

    # -- stats ----------------------------------------------------------------------------------

    def multi_owner_frames(self) -> int:
        return sum(len(s) > 1 for s in self.frame_owner_sets)

    def stats(self) -> Dict[str, float]:
        s = dict(self.pool.stats)
        s.update(
            occupancy=self.pool.occupancy(),
            coalesced_fraction=self.pool.coalesced_fraction(),
            memory_bloat=1.0,  # the baseline reserves nothing beyond use
            owners=len(self.tables),
            multi_owner_frames=self.multi_owner_frames(),
            coalesce_opportunities=self.coalesce_opportunities,
        )
        s.update(self.residency.stats)
        return s

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        seen = set()
        for owner, table in self.tables.items():
            for vpn in table.mapped_vpns():
                ppn = table.ppn[vpn]
                assert ppn not in seen, "page mapped twice"
                seen.add(ppn)
                assert self.rmap.get(ppn) == (owner, vpn)
                assert self.pool.page_allocated[ppn]
        assert len(seen) == len(self.rmap)
        assert not (self.residency.resident
                    & ~self.pool.page_allocated).any(), \
            "resident bit on unallocated page"
