"""Per-owner page tables: the virtual→physical mapping consumed by kernels.

Each *owner* (a serving request / protection domain) has a growable virtual
address space of base pages.  The table stores, per virtual page number
(vpn), the physical page number (ppn) in the pool, plus a per-virtual-frame
``coalesced`` bit maintained by the In-Place Coalescer.

The *hardware-facing* view (:func:`pack_batch_tables`) flattens a batch of
owners into dense int32 arrays that the Pallas paged-attention kernel
scalar-prefetches — this is the TPU analogue of the page table walked by the
GPU MMU in the paper.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

UNMAPPED = -1


class PageTable:
    """Virtual address space of one owner (sequence / app)."""

    def __init__(self, frame_pages: int):
        self.frame_pages = frame_pages
        self.ppn: List[int] = []           # vpn -> ppn (UNMAPPED if hole)
        self.coalesced: List[bool] = []    # per virtual frame

    # -- size helpers ----------------------------------------------------------

    @property
    def num_pages(self) -> int:
        return len(self.ppn)

    @property
    def num_vframes(self) -> int:
        return (len(self.ppn) + self.frame_pages - 1) // self.frame_pages

    def vframe_of(self, vpn: int) -> int:
        return vpn // self.frame_pages

    def vpns_of_vframe(self, vf: int) -> range:
        lo = vf * self.frame_pages
        return range(lo, min(lo + self.frame_pages, len(self.ppn)))

    # -- mutation ---------------------------------------------------------------

    def append(self, ppn: int) -> int:
        """Map the next vpn to ``ppn``; returns the vpn."""
        vpn = len(self.ppn)
        self.ppn.append(ppn)
        while self.num_vframes > len(self.coalesced):
            self.coalesced.append(False)
        return vpn

    def set(self, vpn: int, ppn: int) -> None:
        self.ppn[vpn] = ppn

    def unmap(self, vpn: int) -> int:
        old = self.ppn[vpn]
        assert old != UNMAPPED
        self.ppn[vpn] = UNMAPPED
        return old

    def mapped_vpns(self) -> List[int]:
        return [v for v, p in enumerate(self.ppn) if p != UNMAPPED]

    # -- coalescing queries (In-Place Coalescer conditions, paper §2) -----------

    def vframe_full(self, vf: int) -> bool:
        vpns = self.vpns_of_vframe(vf)
        return len(vpns) == self.frame_pages and all(
            self.ppn[v] != UNMAPPED for v in vpns
        )

    def vframe_contiguous_aligned(self, vf: int) -> Tuple[bool, int]:
        """Is virtual frame ``vf`` backed by one aligned physical frame?

        Returns (ok, physical_frame).  The condition mirrors the paper's
        In-Place Coalescer check: all base pages present, physically
        contiguous, *and* aligned within the large page frame.
        """
        if not self.vframe_full(vf):
            return False, -1
        base_vpn = vf * self.frame_pages
        p0 = self.ppn[base_vpn]
        if p0 % self.frame_pages != 0:
            return False, -1
        for s in range(1, self.frame_pages):
            if self.ppn[base_vpn + s] != p0 + s:
                return False, -1
        return True, p0 // self.frame_pages


def pack_batch_tables(
    tables: Sequence[PageTable],
    max_pages: int,
    frame_pages: int,
) -> Dict[str, np.ndarray]:
    """Flatten a batch of page tables into kernel-facing dense arrays.

    Returns:
      page_tables:  int32[batch, max_pages]      vpn -> ppn (UNMAPPED padding)
      frame_tables: int32[batch, max_vframes]    vframe -> physical frame
                     (UNMAPPED when the vframe is not coalesced)
      coalesced:    int32[batch, max_vframes]    1 if vframe coalesced
      seq_pages:    int32[batch]                 #mapped pages per owner
    """
    batch = len(tables)
    max_vframes = max_pages // frame_pages
    page_tables = np.full((batch, max_pages), UNMAPPED, dtype=np.int32)
    frame_tables = np.full((batch, max_vframes), UNMAPPED, dtype=np.int32)
    coalesced = np.zeros((batch, max_vframes), dtype=np.int32)
    seq_pages = np.zeros((batch,), dtype=np.int32)
    for i, t in enumerate(tables):
        n = min(t.num_pages, max_pages)
        page_tables[i, :n] = np.asarray(t.ppn[:n], dtype=np.int32)
        seq_pages[i] = len(t.mapped_vpns())
        for vf in range(min(t.num_vframes, max_vframes)):
            if vf < len(t.coalesced) and t.coalesced[vf]:
                ok, pf = t.vframe_contiguous_aligned(vf)
                assert ok, "coalesced bit set on non-contiguous vframe"
                frame_tables[i, vf] = pf
                coalesced[i, vf] = 1
    return {
        "page_tables": page_tables,
        "frame_tables": frame_tables,
        "coalesced": coalesced,
        "seq_pages": seq_pages,
    }
