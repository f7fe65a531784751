"""Demand paging: host-DRAM ↔ HBM base-page transfers.

Paper §1: demand paging transfers a page over the system I/O bus when a
thread touches an unallocated page; Mosaic's point is that transfers stay at
*base-page* granularity even when translation uses large pages, so a fault
never over-fetches.

TPU adaptation (DESIGN.md §2): the "system I/O bus" is the host↔device link
(PCIe on TPU hosts too).  The serving engine keeps cold KV pages in host
DRAM (prefix caches, preempted requests, >HBM working sets) and faults them
in at base-page granularity.  This module tracks residency and batches the
faults of one engine step into a single gather-transfer (one device_put per
step rather than per page), which is how a real TPU host would amortize
launch overhead.

Contiguity helps *transfer* too (paper §4.2): base pages that are
physically contiguous — which under Mosaic they are whenever CoCoA kept the
frame intact — merge into a single DMA descriptor, so a batch of faults
pays one setup cost per contiguous run rather than one per page.
:class:`FaultBatch` makes that executable: it splits the faulted ppns into
maximal contiguous runs and charges ``setup_us`` once per run.

Latency accounting mirrors the paper's PCIe model (measured GTX 1080 curves:
fixed setup cost + per-byte cost) so the TLB/paging simulator and the real
engine agree on what a fault costs; see :mod:`repro.core.tlb_sim`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

# Paper's base page (4KB); engines override with the true KV bytes/page.
DEFAULT_PAGE_BYTES = 4096


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """System I/O bus latency model (paper §3: modeled from GTX 1080).

    latency(bytes) = setup_us + bytes / bandwidth_gbps
    """

    setup_us: float = 10.0          # per-transfer fixed cost (driver+DMA setup)
    bandwidth_GBps: float = 12.0    # effective PCIe 3.0 x16 ≈ 12 GB/s

    def transfer_us(self, nbytes: int) -> float:
        return self.setup_us + nbytes / (self.bandwidth_GBps * 1e3)


def contiguous_runs(ppns: Sequence[int]) -> List[Tuple[int, int]]:
    """Maximal runs of physically-contiguous pages as (start, length).

    The input order is irrelevant: DMA descriptors address physical memory,
    so runs are computed over the sorted ppn set.
    """
    if not ppns:
        return []
    ps = sorted(set(int(p) for p in ppns))
    runs: List[Tuple[int, int]] = []
    start = prev = ps[0]
    for p in ps[1:]:
        if p == prev + 1:
            prev = p
            continue
        runs.append((start, prev - start + 1))
        start = prev = p
    runs.append((start, prev - start + 1))
    return runs


@dataclasses.dataclass
class FaultBatch:
    """One engine-step's worth of page faults, batched for transfer.

    Base pages belonging to the same coalesced frame are physically
    contiguous (CoCoA), so they merge into one DMA; scattered pages pay one
    setup each.  This is where contiguity helps *transfer* too.
    """

    ppns: List[int]
    page_bytes: int
    link: LinkModel

    @property
    def nbytes(self) -> int:
        return len(self.ppns) * self.page_bytes

    @functools.cached_property
    def runs(self) -> List[Tuple[int, int]]:
        # Effectively immutable after construction; callers read dma_count
        # and transfer_us repeatedly on the fault hot path.
        return contiguous_runs(self.ppns)

    @property
    def dma_count(self) -> int:
        """Number of DMA descriptors (one per contiguous run)."""
        return len(self.runs)

    @property
    def transfer_us(self) -> float:
        if not self.ppns:
            return 0.0
        return sum(self.link.transfer_us(n * self.page_bytes)
                   for _, n in self.runs)


class ResidencyTracker:
    """Tracks which physical pages are HBM-resident vs host-only.

    Lifecycle hooks (called by the managers, DESIGN.md §6):

    * ``mark_resident`` — a freshly-allocated page is device-written by the
      next prefill/decode step, so it is resident with zero transfer;
    * ``demote`` — the page's payload lives in the host tier (a resumed
      request's re-allocated pages); the next ``touch`` reports it missing;
    * ``fault_in`` — batch host→device transfer, accounted per DMA run;
    * ``evict`` — device→host transfer (preemption / cold-page spill);
    * ``release`` — the allocator freed the page: residency drops silently;
    * ``on_copy`` — a compaction ``CopyOp`` moved the payload on-device:
      the destination inherits the source's residency state.
    """

    def __init__(self, num_pages: int, page_bytes: int, link: LinkModel | None = None):
        self.resident = np.zeros(num_pages, dtype=bool)
        self.page_bytes = page_bytes
        self.link = link or LinkModel()
        self.stats = {"faults": 0, "fault_batches": 0, "dma_transfers": 0,
                      "bytes_in": 0, "evictions": 0, "bytes_out": 0,
                      "transfer_us": 0.0}

    def touch(self, ppns: Sequence[int]) -> List[int]:
        """Mark pages as about-to-be-accessed; return the non-resident ones."""
        missing = [p for p in ppns if not self.resident[p]]
        return missing

    def fault_in(self, ppns: Sequence[int]) -> FaultBatch:
        """Batch-fault pages in; marks them resident and accounts transfer."""
        missing = [p for p in ppns if not self.resident[p]]
        for p in missing:
            self.resident[p] = True
        batch = FaultBatch(missing, self.page_bytes, self.link)
        if missing:
            self.stats["faults"] += len(missing)
            self.stats["fault_batches"] += 1
            self.stats["dma_transfers"] += batch.dma_count
            self.stats["bytes_in"] += batch.nbytes
            self.stats["transfer_us"] += batch.transfer_us
        return batch

    def evict(self, ppns: Sequence[int]) -> int:
        """Device→host spill: accounts the outbound transfer."""
        n = 0
        for p in ppns:
            if self.resident[p]:
                self.resident[p] = False
                n += 1
        self.stats["evictions"] += n
        self.stats["bytes_out"] += n * self.page_bytes
        return n

    def mark_resident(self, ppns: Sequence[int]) -> None:
        """Freshly-allocated pages: device-written, no transfer."""
        for p in ppns:
            self.resident[p] = True

    def demote(self, ppns: Sequence[int]) -> None:
        """Payload lives on host (already accounted at eviction time)."""
        for p in ppns:
            self.resident[p] = False

    def release(self, ppns: Sequence[int]) -> None:
        """Pages freed by the allocator: drop residency without transfer."""
        for p in ppns:
            self.resident[p] = False

    def on_copy(self, src_ppn: int, dst_ppn: int) -> None:
        """Compaction moved the payload src→dst on-device: residency moves
        with it (a non-resident source stays host-backed at the new ppn)."""
        self.resident[dst_ppn] = self.resident[src_ppn]
        self.resident[src_ppn] = False
