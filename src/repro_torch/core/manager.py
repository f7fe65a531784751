"""Mosaic memory manager facade: CoCoA + In-Place Coalescer + CAC.

This is the object the serving engine talks to.  It tracks one
:class:`PageTable` per owner (request / protection domain), the global
reverse map ppn→(owner, vpn) needed by compaction, and token-level sizes.

The same interface is implemented by
:class:`repro.core.baseline_mmu.BaselineMMU` (the GPU-MMU baseline of
Power et al. used throughout the paper's evaluation), so engines and
benchmarks can swap managers with one flag.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import page_table as pt
from repro_torch.core.coalescer import InPlaceCoalescer
from repro_torch.core.cocoa import CoCoA, OutOfMemory
from repro_torch.core.compaction import CAC, CompactionPlan, CopyOp
from repro_torch.core.demand_paging import (
    DEFAULT_PAGE_BYTES,
    LinkModel,
    ResidencyTracker,
)
from repro_torch.core.pagepool import PagePool, PoolConfig


def pages_for_tokens(n_tokens: int, page_tokens: int) -> int:
    return (n_tokens + page_tokens - 1) // page_tokens


class MosaicManager:
    name = "mosaic"

    def __init__(self, config: PoolConfig, *,
                 link: Optional[LinkModel] = None, page_bytes: int = 0):
        self.config = config
        self.pool = PagePool(config)
        self.coalescer = InPlaceCoalescer(self.pool)
        self.cocoa = CoCoA(self.pool, self.coalescer)
        self.cac = CAC(self.pool, self.coalescer)
        self.tables: Dict[int, pt.PageTable] = {}
        self.seq_tokens: Dict[int, int] = {}
        self.rmap: Dict[int, Tuple[int, int]] = {}
        self._pending_copies: List[CopyOp] = []
        # Host-tier residency (DESIGN.md §6): same hooks as BaselineMMU so
        # engines/benchmarks measure demand paging under either manager.
        self.residency = ResidencyTracker(
            config.num_pages, page_bytes or DEFAULT_PAGE_BYTES, link)

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

    # -- allocation --------------------------------------------------------------

    def allocate_tokens(self, owner: int, n_tokens: int) -> List[int]:
        """En-masse allocation for ``n_tokens`` (prefill).  Returns new vpns."""
        table = self._table(owner)
        have = pages_for_tokens(self.seq_tokens[owner], self.config.page_tokens)
        need = pages_for_tokens(self.seq_tokens[owner] + n_tokens,
                                self.config.page_tokens) - have
        vpns = self._with_compaction_retry(
            owner, lambda: self.cocoa.alloc_en_masse(owner, table, need)
        )
        for vpn in vpns:
            self.rmap[table.ppn[vpn]] = (owner, vpn)
        self.residency.mark_resident([table.ppn[v] for v in vpns])
        self.seq_tokens[owner] += n_tokens
        return vpns

    def append_tokens(self, owner: int, n_tokens: int = 1) -> List[int]:
        """Decode-time growth; allocates pages lazily at page boundaries."""
        table = self._table(owner)
        new_vpns: List[int] = []
        for _ in range(n_tokens):
            tok = self.seq_tokens[owner]
            if tok % self.config.page_tokens == 0:
                vpn = self._with_compaction_retry(
                    owner, lambda: self.cocoa.append_page(owner, table)
                )
                self.rmap[table.ppn[vpn]] = (owner, vpn)
                self.residency.mark_resident([table.ppn[vpn]])
                new_vpns.append(vpn)
            self.seq_tokens[owner] = tok + 1
        return new_vpns

    def _with_compaction_retry(self, owner: int, fn):
        try:
            return fn()
        except OutOfMemory:
            # Paper step 9–10: compaction frees frames for future allocations.
            for o in self.owners():
                self.compact(o)
            return fn()

    # -- deallocation --------------------------------------------------------------

    def free_pages(self, owner: int, vpns: Sequence[int]) -> None:
        """Partial dealloc (eviction/trim): splinter + unmap + CAC check."""
        table = self.tables[owner]
        self.cac.splinter_for_dealloc(table, vpns)
        for vpn in vpns:
            ppn = table.unmap(vpn)
            self.rmap.pop(ppn, None)
            self.pool.free_page(ppn)
            self.residency.release([ppn])
        self.compact(owner)

    def deallocate(self, owner: int) -> None:
        """Full owner teardown (kernel/request completion)."""
        table = self.tables.pop(owner)
        for vf in range(table.num_vframes):
            self.coalescer.splinter(table, vf)
        for vpn in table.mapped_vpns():
            ppn = table.unmap(vpn)
            self.rmap.pop(ppn, None)
            self.pool.free_page(ppn)
            self.residency.release([ppn])
        self.seq_tokens.pop(owner, None)
        self.cocoa.forget_owner(owner)

    # -- compaction ---------------------------------------------------------------

    def compact(self, owner: int) -> CompactionPlan:
        if owner not in self.tables:
            return CompactionPlan([], [])
        plan = self.cac.compact_owner(owner, self.tables[owner], self.rmap)
        for op in plan.copies:
            # Residency moves with the payload: a host-backed (non-resident)
            # page stays host-backed at its new physical location.
            self.residency.on_copy(op.src_ppn, op.dst_ppn)
        self._pending_copies.extend(plan.copies)
        return plan

    def drain_copy_ops(self) -> List[CopyOp]:
        """Device copies the engine must execute (page_compact kernel)."""
        ops, self._pending_copies = self._pending_copies, []
        return ops

    # -- kernel-facing views ---------------------------------------------------------

    def pack(self, owners: Sequence[int], max_pages: int) -> Dict[str, np.ndarray]:
        packed = pt.pack_batch_tables(
            [self.tables[o] for o in owners], max_pages, self.config.frame_pages
        )
        packed["seq_tokens"] = np.asarray(
            [self.seq_tokens[o] for o in owners], dtype=np.int32
        )
        return packed

    # -- stats -------------------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        s = dict(self.pool.stats)
        s.update(
            occupancy=self.pool.occupancy(),
            coalesced_fraction=self.pool.coalesced_fraction(),
            memory_bloat=self.pool.memory_bloat(),
            owners=len(self.tables),
        )
        s.update(self.residency.stats)
        return s

    def check_invariants(self) -> None:
        self.pool.check_invariants()
        # Cross-structure: every mapped page appears in rmap exactly once and
        # coalesced bits imply contiguity+alignment (I6/I7 in tests).
        seen = set()
        for owner, table in self.tables.items():
            for vpn in table.mapped_vpns():
                ppn = table.ppn[vpn]
                assert ppn not in seen, "page mapped twice"
                seen.add(ppn)
                assert self.rmap.get(ppn) == (owner, vpn), "rmap mismatch"
                assert self.pool.page_allocated[ppn], "mapped page not allocated"
                f = self.pool.frame_of(ppn)
                assert self.pool.frame_owner[f] == owner, "soft guarantee violated"
            for vf, c in enumerate(table.coalesced):
                if c:
                    ok, _ = table.vframe_contiguous_aligned(vf)
                    assert ok, "coalesced bit on non-contiguous vframe"
        assert len(seen) == len(self.rmap), "stale rmap entries"
        # Residency ⊆ allocation: a free page never claims a device payload.
        assert not (self.residency.resident
                    & ~self.pool.page_allocated).any(), \
            "resident bit on unallocated page"
