"""Radix page-table walker + contiguity-coalesced TLB entries (DESIGN.md §15).

The flat walker in :mod:`repro_torch.core.tlb_sim` charges every TLB miss a
constant ``walk_levels × dram_latency`` — the paper's contiguity ⇒
cheap-translation chain is asserted, not measured.  This module makes it
measurable:

* :class:`RadixWalker` — a multi-level radix walk (x86-64-style: ``bits``
  index bits per level) with **per-level page-walk caches** (PWCs): a walk
  probes the PWCs deepest-intermediate-level first and skips every level
  already cached, so only the uncached tail issues serialized DRAM
  accesses.  ``walker_slots`` concurrent walks share the walker (FIFO
  overflow, exactly the flat walker's queueing mechanics), an MSHR merges
  duplicate in-flight walks, and per-level DRAM accesses plus per-app
  latency/queue-interference are accounted (MASK's cross-app walker
  interference, arxiv 1708.04911).

* :class:`CoalescedTLB` — subregion-coalesced entries (Large-Reach TLBs
  via subregion contiguity, arxiv 2110.08613): one entry covers the run
  of contiguously-mapped base pages inside a ``span``-page subregion.
  Coverage is **derived from the actual frame map** the allocator
  produced (``ppn[v] == base + (v - base_vpn)``), not from an oracle
  bit — CoCoA's contiguity-preserving allocation widens every entry's
  reach, the baseline's interleaved frames collapse it to one page.
  Splintering a page invalidates only the touched subregion's entry.

* :class:`TranslationMeter` — the serving-side adapter: one L1/L2
  coalesced TLB + radix walker per engine, fed the KV page tables each
  decode step touches.  Purely observational for decode timing (tokens
  are byte-identical with it on or off), but its walker backlog is the
  optional translation-interference term
  :meth:`repro_torch.serving.router.RequestRouter.engine_cost_us` charges.

Bitwise compatibility: with PWCs disabled (``pwc_entries=0``) and
``span=1`` the radix walker performs full-depth walks of exactly
``levels × dram_latency`` cycles with the flat walker's slot mechanics
and MSHR rule — the parity the ``translation`` bench and
``tests/test_ptw.py`` pin against ``translation="flat"``.
"""

from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


# ----------------------------------------------------------------- subregions


def subregion_entry(ppn_map: Sequence[int], vpn: int, span: int
                    ) -> Tuple[int, int]:
    """Build a coalesced TLB entry for the subregion containing ``vpn``.

    Returns ``(delta, mask)``: ``delta = ppn - vpn`` for the walked page,
    and ``mask`` has bit ``o`` set when page ``base + o`` of the
    ``span``-aligned subregion is mapped with the *same* delta — i.e. its
    translation is derivable from the entry (``ppn = vpn + delta``).
    Coverage comes from the frame map itself, never from an oracle bit.
    """
    delta = int(ppn_map[vpn]) - vpn
    base = (vpn // span) * span
    mask = 0
    n = len(ppn_map)
    for o in range(span):
        v = base + o
        if v < n and int(ppn_map[v]) >= 0 and int(ppn_map[v]) - v == delta:
            mask |= 1 << o
    return delta, mask


class CoalescedTLB:
    """Fully-associative LRU of subregion-coalesced entries.

    Keyed by subregion tag (``vpn // span``, plus whatever address-space
    discriminator the caller folds into the key); the stored entry is the
    ``(delta, mask)`` pair of :func:`subregion_entry`.  A lookup hits only
    when the tag is present *and* the entry's coverage mask includes the
    page — a present-but-uncovered page (a delta conflict inside the
    subregion, or a splintered page) is a miss that re-walks.
    """

    __slots__ = ("cap", "span", "d", "hits", "misses")

    def __init__(self, cap: int, span: int = 1):
        assert span >= 1
        self.cap = cap
        self.span = span
        self.d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, tag, off: int) -> Optional[Tuple[int, int]]:
        e = self.d.get(tag)
        if e is not None and (e[1] >> off) & 1:
            self.d.move_to_end(tag)
            self.hits += 1
            return e
        self.misses += 1
        return None

    def insert(self, tag, entry: Tuple[int, int]) -> None:
        if tag in self.d:
            self.d[tag] = entry
            self.d.move_to_end(tag)
            return
        if len(self.d) >= self.cap and self.cap > 0:
            self.d.popitem(last=False)
        if self.cap > 0:
            self.d[tag] = entry

    def invalidate(self, tag) -> bool:
        """Drop the entry for one subregion (CoCoA splintered a page in
        it).  Entries for every other subregion are untouched — the
        selective invalidation the ``ptw`` property tests pin."""
        return self.d.pop(tag, None) is not None

    @property
    def rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else float("nan")

    def reach_pages(self) -> int:
        """Base pages currently covered across all resident entries —
        the TLB-reach figure coalescing widens."""
        return sum(bin(e[1]).count("1") for e in self.d.values())


# --------------------------------------------------------------- radix walker


class RadixWalker:
    """Multi-level radix page-table walker with per-level walk caches.

    A walk is ``levels`` serialized memory accesses (root → leaf PTE).
    PWC ``i`` caches the intermediate entry fetched by access ``i + 1``
    (the leaf PTE itself goes to the TLB, not a PWC), keyed by
    ``(app, vpn >> bits·(levels - level))``.  The walk probes deepest
    intermediate level first; a hit at level ``ℓ`` leaves only the
    ``levels - ℓ`` tail accesses to DRAM.  ``slots`` concurrent walks
    share the walker with FIFO overflow — the same mechanics (and, with
    PWCs disabled, the same timings to the cycle) as the flat walker.
    An MSHR merges duplicate in-flight walks under the flat path's rule.
    """

    def __init__(self, slots: int, levels: int, dram_latency: int, *,
                 pwc_entries: int = 64, pwc_latency: int = 2,
                 bits: int = 9, n_apps: int = 1):
        assert levels >= 1
        self.slots = slots
        self.levels = levels
        self.dram_latency = dram_latency
        self.pwc_latency = pwc_latency
        self.bits = bits
        # pwcs[i] caches level i+1 entries, i in [0, levels-2].
        self.pwcs = [_TagLRU(pwc_entries) for _ in range(levels - 1)]
        self._busy: List[float] = []       # heap of walk finish times
        self.walks = 0
        self.merged = 0                    # MSHR-merged duplicate misses
        self.stall_cycles = 0.0            # slot-queue wait, all apps
        self.peak_inflight = 0
        self.level_accesses = [0] * levels     # DRAM accesses per level
        self.app_walks = [0] * n_apps
        self.app_walk_cycles = [0.0] * n_apps  # latency past the L2 miss
        self.app_queue_cycles = [0.0] * n_apps  # slot-wait (interference)
        self.mshr: Dict[object, float] = {}

    # -- caches ------------------------------------------------------------

    def _pwc_tag(self, vpn: int, level: int) -> int:
        return vpn >> (self.bits * (self.levels - level))

    def pwc_hit_rate(self) -> float:
        h = sum(p.hits for p in self.pwcs)
        m = sum(p.misses for p in self.pwcs)
        n = h + m
        return h / n if n else float("nan")

    # -- the walk ----------------------------------------------------------

    def walk(self, now: float, t0: float, app: int, vpn: int,
             key) -> float:
        """Resolve a TLB miss requested at ``now`` whose walk may begin
        at ``t0`` (after the L1+L2 probe latencies).  Returns the cycle
        the translation resolves.  Duplicate in-flight misses on ``key``
        merge into the existing walk (the flat path's MSHR rule)."""
        got = self.mshr.get(key)
        if got is not None and got > now:
            self.merged += 1
            return got
        # Deepest already-cached intermediate level: those accesses skip.
        skip = 0
        for lvl in range(self.levels - 1, 0, -1):
            if self.pwcs[lvl - 1].lookup((app, self._pwc_tag(vpn, lvl))):
                skip = lvl
                break
        accesses = self.levels - skip
        duration = accesses * self.dram_latency \
            + (self.pwc_latency if skip else 0)
        # Slot queue: identical mechanics to the flat walker.
        while self._busy and self._busy[0] <= t0:
            heapq.heappop(self._busy)
        if len(self._busy) < self.slots:
            begin = t0
        else:
            begin = heapq.heappop(self._busy)      # wait for a slot
            self.stall_cycles += begin - t0
            if app < len(self.app_queue_cycles):
                self.app_queue_cycles[app] += begin - t0
        finish = begin + duration
        heapq.heappush(self._busy, finish)
        self.peak_inflight = max(self.peak_inflight, len(self._busy))
        self.walks += 1
        for lvl in range(skip + 1, self.levels + 1):
            self.level_accesses[lvl - 1] += 1
        # The walk fetched every uncached intermediate entry: cache them.
        for lvl in range(skip + 1, self.levels):
            self.pwcs[lvl - 1].insert((app, self._pwc_tag(vpn, lvl)))
        if app < len(self.app_walks):
            self.app_walks[app] += 1
            self.app_walk_cycles[app] += finish - t0
        self.mshr[key] = finish
        return finish

    # -- occupancy (router / cost-model parity hook) -----------------------

    def backlog(self, now: float) -> float:
        """Booked walker time beyond ``now`` (cycles): the queueing a
        newly-missing translation would experience.  Monotone in booked
        walks — the serving router's translation-interference term."""
        return sum(max(0.0, t - now) for t in self._busy)

    def dram_accesses(self) -> int:
        return sum(self.level_accesses)


class _TagLRU:
    """Tag-only LRU (the flat sim's LRU, minus the never-touched-rate
    wart): capacity 0 never hits and never stores."""

    __slots__ = ("cap", "d", "hits", "misses")

    def __init__(self, cap: int):
        self.cap = cap
        self.d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, tag) -> bool:
        if tag in self.d:
            self.d.move_to_end(tag)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def insert(self, tag) -> None:
        if tag in self.d:
            self.d.move_to_end(tag)
            return
        if len(self.d) >= self.cap and self.cap > 0:
            self.d.popitem(last=False)
        if self.cap > 0:
            self.d[tag] = True

    @property
    def rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else float("nan")


# ------------------------------------------------------------ serving meter


class TranslationMeter:
    """Per-engine translation model for the serving tier (DESIGN.md §15).

    Each decode step the engine feeds it the KV page tables the step's
    packed batch reads; the meter runs every page through an L1/L2
    coalesced-TLB + radix-walker pipeline on the engine's modeled µs
    clock (converted to cycles at ``clock_ghz``).  It is observational —
    decode timing and tokens are untouched — but it exports:

    * per-app (tenant) translation cycles and walk counts,
    * PWC / TLB hit rates,
    * walker slot-queue interference, and
    * :meth:`backlog_us` — the walker's booked-time-beyond-now, the
      optional translation-interference term the request router charges.

    ``mode="flat"`` degrades to the flat model (span-1 entries, PWCs
    off, every walk full depth) so flat/radix can be A/B'd per engine.
    """

    def __init__(self, mode: str = "radix", *, span: int = 4,
                 l1_entries: int = 64, l2_entries: int = 256,
                 levels: int = 4, dram_latency: int = 160,
                 pwc_entries: int = 16, pwc_latency: int = 2,
                 walker_slots: int = 8, l1_latency: int = 1,
                 l2_latency: int = 10, clock_ghz: float = 1.02):
        if mode not in ("flat", "radix"):
            raise ValueError(
                f"translation mode must be 'flat' or 'radix', got {mode!r}")
        self.mode = mode
        if mode == "flat":
            span, pwc_entries = 1, 0
        self.span = span
        self.l1_latency = l1_latency
        self.l2_latency = l2_latency
        self.cycles_per_us = clock_ghz * 1e3
        self.l1 = CoalescedTLB(l1_entries, span)
        self.l2 = CoalescedTLB(l2_entries, span)
        self.walker = RadixWalker(walker_slots, levels, dram_latency,
                                  pwc_entries=pwc_entries,
                                  pwc_latency=pwc_latency)
        self.lookups = 0
        self.cycles_by_app: Dict[object, float] = {}
        self.walks_by_app: Dict[object, int] = {}

    # -- per-step driving --------------------------------------------------

    def step_access(self, now_us: float,
                    tables: Iterable[Tuple[object, object, Sequence[int]]]
                    ) -> Dict[str, float]:
        """Translate one decode step's page touches.

        ``tables`` yields ``(space, app, ppn_map)``: a distinct address
        space (seq/shard), the app label its latency is charged to, and
        the space's vpn→ppn map (the actual frame map the allocator
        produced — contiguity coverage is derived from it).  Returns the
        step's deltas for the engine's stats counters.
        """
        now = now_us * self.cycles_per_us
        d = {"lookups": 0, "tlb_hits": 0, "walks": 0, "walk_cycles": 0.0,
             "queue_cycles": 0.0, "latency_cycles": 0.0}
        w = self.walker
        walks0, stall0 = w.walks, w.stall_cycles
        merged0, wcyc0 = w.merged, w.app_walk_cycles[0]
        for space, app, ppn_map in tables:
            app_cycles = 0.0
            app_walks0 = w.walks
            for vpn in range(len(ppn_map)):
                if int(ppn_map[vpn]) < 0:
                    continue                      # unmapped hole
                done = self._translate(now, space, app, vpn, ppn_map)
                d["lookups"] += 1
                app_cycles += done - now
            d["latency_cycles"] += app_cycles
            self.cycles_by_app[app] = \
                self.cycles_by_app.get(app, 0.0) + app_cycles
            self.walks_by_app[app] = \
                self.walks_by_app.get(app, 0) + (w.walks - app_walks0)
        d["walks"] = w.walks - walks0
        d["queue_cycles"] = w.stall_cycles - stall0
        d["tlb_hits"] = d["lookups"] - d["walks"] - (w.merged - merged0)
        d["walk_cycles"] = w.app_walk_cycles[0] - wcyc0
        self.lookups += d["lookups"]
        return d

    def _translate(self, now: float, space, app, vpn: int,
                   ppn_map) -> float:
        sreg, off = divmod(vpn, self.span)
        tag = (space, sreg)
        if self.l1.lookup(tag, off) is not None:
            return now + self.l1_latency
        e = self.l2.lookup(tag, off)
        if e is not None:
            self.l1.insert(tag, e)
            return now + self.l1_latency + self.l2_latency
        t0 = now + self.l1_latency + self.l2_latency
        # App index for the walker's per-app arrays is unused here (the
        # meter keeps its own dicts); charge everything to slot 0.
        done = self.walker.walk(now, t0, 0, vpn, (space, sreg))
        entry = subregion_entry(ppn_map, vpn, self.span)
        self.l2.insert(tag, entry)
        self.l1.insert(tag, entry)
        return done

    # -- invalidation ------------------------------------------------------

    def splinter(self, space, vpn: int) -> None:
        """A page of ``space`` was remapped (CAC compaction / splinter):
        invalidate only the touched subregion's entries."""
        tag = (space, vpn // self.span)
        self.l1.invalidate(tag)
        self.l2.invalidate(tag)

    def drop_space(self, space) -> None:
        """The address space retired: drop its entries wholesale."""
        for tlb in (self.l1, self.l2):
            for tag in [t for t in tlb.d if t[0] == space]:
                del tlb.d[tag]
        for key in [k for k in self.walker.mshr if k[0] == space]:
            del self.walker.mshr[key]

    # -- export ------------------------------------------------------------

    def backlog_us(self, now_us: float) -> float:
        return self.walker.backlog(now_us * self.cycles_per_us) \
            / self.cycles_per_us

    def cycles_us(self, cycles: float) -> float:
        return cycles / self.cycles_per_us

    def summary(self) -> str:
        per_app = " | ".join(
            f"app{a}: {c:.0f} cyc / {self.walks_by_app.get(a, 0)} walks"
            for a, c in sorted(self.cycles_by_app.items()))
        l1r, pwcr = self.l1.rate, self.walker.pwc_hit_rate()
        return (f"translation[{self.mode}] span={self.span}: "
                f"{per_app or 'no lookups'} | "
                f"l1 {0.0 if math.isnan(l1r) else l1r:.1%} | "
                f"pwc {0.0 if math.isnan(pwcr) else pwcr:.1%} | "
                f"queue {self.walker.stall_cycles:.0f} cyc | "
                f"dram {self.walker.dram_accesses()}")
