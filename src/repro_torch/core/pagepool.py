"""Physical page-pool bookkeeping for the Mosaic memory manager.

The pool models a device-resident region of HBM carved into ``num_pages``
*base pages* of ``page_tokens`` tokens each.  Pages are grouped into aligned
*large frames* of ``frame_pages`` consecutive pages (the TPU analogue of the
paper's 2 MB large-page frame; see DESIGN.md §5 for the re-tiling rationale).

This module owns only *physical* state: which pages are allocated, which
frame owns them, and which frames are coalesced.  Virtual-to-physical policy
lives in :mod:`repro.core.cocoa` (Mosaic) and
:mod:`repro.core.baseline_mmu` (the GPU-MMU baseline of Power et al.).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Set

import numpy as np

FREE = -1  # sentinel owner id for unowned frames / unallocated pages


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Geometry of the physical page pool.

    Attributes:
      num_pages:    total base pages in the pool (must be a multiple of
                    ``frame_pages``).
      frame_pages:  base pages per large frame (paper: 512 = 2MB/4KB; TPU
                    default 16, see DESIGN.md §5).
      page_tokens:  tokens of KV state per base page (TPU default 64).
      compact_threshold: CAC fragmentation trigger — a *splintered* frame
                    whose unallocated fraction exceeds this becomes a
                    compaction source (paper §2, "predetermined threshold").
    """

    num_pages: int
    frame_pages: int = 16
    page_tokens: int = 64
    compact_threshold: float = 0.5

    def __post_init__(self) -> None:
        if self.num_pages % self.frame_pages != 0:
            raise ValueError(
                f"num_pages={self.num_pages} not a multiple of "
                f"frame_pages={self.frame_pages}"
            )

    @property
    def num_frames(self) -> int:
        return self.num_pages // self.frame_pages

    @property
    def frame_tokens(self) -> int:
        return self.frame_pages * self.page_tokens


class PagePool:
    """Physical state: page allocation bits, frame ownership, coalesced bits.

    Invariants (checked by :meth:`check_invariants`, property-tested):
      I1  a page is allocated iff its frame has an owner.
      I2  ``frame_used[f]`` == number of allocated pages in frame ``f``.
      I3  a frame with ``frame_used == 0`` is unowned and on the free list.
      I4  a coalesced frame is fully allocated (``frame_used == frame_pages``).
      I5  every frame is either on the free list xor owned.
    """

    def __init__(self, config: PoolConfig):
        self.config = config
        n_f = config.num_frames
        self.page_allocated = np.zeros(config.num_pages, dtype=bool)
        self.frame_owner = np.full(n_f, FREE, dtype=np.int64)
        self.frame_used = np.zeros(n_f, dtype=np.int32)
        self.frame_coalesced = np.zeros(n_f, dtype=bool)
        # Free frames: min-heap with lazy deletion + membership set, so we get
        # deterministic low-address-first frame selection (helps contiguity)
        # *and* O(log n) removal of a specific frame (needed by the baseline
        # MMU, which allocates pages without frame awareness).
        self._free_heap: List[int] = list(range(n_f))
        heapq.heapify(self._free_heap)
        self._free_set: Set[int] = set(range(n_f))
        # Statistics (read by benchmarks / EXPERIMENTS.md tables).
        self.stats = {
            "frames_allocated": 0,
            "frames_released": 0,
            "pages_allocated": 0,
            "pages_freed": 0,
            "coalesce_ops": 0,
            "splinter_ops": 0,
            "compaction_copies": 0,
        }

    # -- frame-granularity ops ------------------------------------------------

    @property
    def num_free_frames(self) -> int:
        return len(self._free_set)

    def free_frame_ids(self) -> Set[int]:
        return set(self._free_set)

    def take_free_frame(self, owner: int) -> Optional[int]:
        """Pop the lowest-addressed free frame for ``owner``; None if full."""
        while self._free_heap:
            f = heapq.heappop(self._free_heap)
            if f in self._free_set:  # skip lazily-deleted entries
                self._free_set.discard(f)
                self.frame_owner[f] = owner
                self.stats["frames_allocated"] += 1
                return f
        return None

    def take_specific_frame(self, f: int, owner: int) -> int:
        """Claim a specific free frame (baseline MMU path; lazy heap delete)."""
        assert f in self._free_set, f"frame {f} is not free"
        self._free_set.discard(f)
        self.frame_owner[f] = owner
        self.stats["frames_allocated"] += 1
        return f

    def take_free_frames(self, owner: int, n: int) -> Optional[List[int]]:
        """Pop ``n`` free frames at once (en-masse allocation path)."""
        if len(self._free_set) < n:
            return None
        return [self.take_free_frame(owner) for _ in range(n)]

    def release_frame(self, f: int) -> None:
        assert self.frame_used[f] == 0, f"releasing non-empty frame {f}"
        self.frame_owner[f] = FREE
        self.frame_coalesced[f] = False
        self._free_set.add(f)
        heapq.heappush(self._free_heap, f)
        self.stats["frames_released"] += 1

    # -- page-granularity ops --------------------------------------------------

    def page_of(self, frame: int, slot: int) -> int:
        return frame * self.config.frame_pages + slot

    def frame_of(self, ppn: int) -> int:
        return ppn // self.config.frame_pages

    def slot_of(self, ppn: int) -> int:
        return ppn % self.config.frame_pages

    def alloc_page(self, frame: int, slot: int) -> int:
        ppn = self.page_of(frame, slot)
        assert not self.page_allocated[ppn], f"double alloc of page {ppn}"
        assert self.frame_owner[frame] != FREE, f"alloc in unowned frame {frame}"
        self.page_allocated[ppn] = True
        self.frame_used[frame] += 1
        self.stats["pages_allocated"] += 1
        return ppn

    def free_page(self, ppn: int) -> None:
        assert self.page_allocated[ppn], f"double free of page {ppn}"
        f = self.frame_of(ppn)
        self.page_allocated[ppn] = False
        self.frame_used[f] -= 1
        self.stats["pages_freed"] += 1
        if self.frame_used[f] == 0:
            self.release_frame(f)

    def free_slots(self, frame: int) -> List[int]:
        base = frame * self.config.frame_pages
        return [
            s
            for s in range(self.config.frame_pages)
            if not self.page_allocated[base + s]
        ]

    # -- fragmentation metrics (paper §4.4 / Fig. 8 analysis) -------------------

    def frame_frag(self, f: int) -> float:
        """Unallocated fraction of an *owned* frame (internal fragmentation)."""
        return 1.0 - self.frame_used[f] / self.config.frame_pages

    def memory_bloat(self) -> float:
        """Paper's 'memory bloat': frames reserved / pages actually used."""
        owned = int((self.frame_owner != FREE).sum())
        used_pages = int(self.page_allocated.sum())
        if used_pages == 0:
            return 1.0
        return owned * self.config.frame_pages / used_pages

    def occupancy(self) -> float:
        return float(self.page_allocated.mean())

    def coalesced_fraction(self) -> float:
        """Fraction of *allocated* pages that live in coalesced frames."""
        total = int(self.page_allocated.sum())
        if total == 0:
            return 0.0
        coalesced_pages = int(
            (self.frame_used * self.frame_coalesced).sum()
        )
        return coalesced_pages / total

    # -- invariant checking (used by hypothesis tests) ---------------------------

    def check_invariants(self) -> None:
        cfg = self.config
        used = self.page_allocated.reshape(cfg.num_frames, cfg.frame_pages)
        per_frame = used.sum(axis=1).astype(np.int32)
        # I2
        assert (per_frame == self.frame_used).all(), "I2: frame_used mismatch"
        # I1: pages allocated only in owned frames
        owned = self.frame_owner != FREE
        assert not (per_frame[~owned] > 0).any(), "I1: pages in unowned frame"
        # I3: empty owned frames are not allowed to linger
        assert not ((per_frame == 0) & owned).any(), "I3: empty owned frame"
        # I4
        assert (
            per_frame[self.frame_coalesced] == cfg.frame_pages
        ).all(), "I4: coalesced frame not full"
        # I5
        for f in range(cfg.num_frames):
            assert (f in self._free_set) != bool(owned[f]), "I5: free xor owned"
