"""Paper-faithful TLB + page-table-walk + demand-paging timing simulator.

This module reproduces the *evaluation apparatus* of the MICRO'17 paper
(§3, Table 1) so that our CoCoA/coalescer/CAC implementations can be
validated against the paper's own claims (Figs. 1, 5, 6, 7, 8):

  * per-core L1 TLB: 128 base-page + 16 large-page entries, LRU, 1 cycle;
  * shared L2 TLB: 512 base + 256 large entries, LRU, 10-cycle latency;
  * shared page-table walker, 64 concurrent walks, each walk = 4 serialized
    memory accesses (x86-64 radix table, as in Power et al.);
  * MSHRs merging duplicate in-flight walks;
  * demand paging over the system I/O bus (PCIe model: setup + per-byte);
  * GTO-style warp issue: W warps per app round-robin their memory trace;
    a warp blocks until translation + fault resolve — so one miss stalls
    every warp that touches the page, the paper's core TLP argument.

Deliberate simplifications (disclosed; see DESIGN.md §2):
  * one aggregate L1 TLB per application instead of one per SM (warps of an
    app see the same working set; per-SM replication changes constants, not
    trends);
  * TLB set-associativity modeled as full-LRU;
  * compute between memory ops collapses to a fixed ``gap_cycles`` drawn
    per app profile (paper's IPC differences across apps live here);
  * DRAM bandwidth contention beyond the walker queue is not modeled.

Performance metric: retired accesses / cycle ("IPC" up to the constant
instructions-per-access factor), and the paper's weighted speedup
``Σ IPC_shared / IPC_alone`` with IPC_alone measured on the baseline
GPU-MMU manager with the same core count (paper §3).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.demand_paging import LinkModel
from repro_torch.core.pagepool import PoolConfig


# --------------------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Table 1 of the paper, plus trace/issue parameters."""

    # TLB hierarchy (entries).
    l1_base_entries: int = 128
    l1_large_entries: int = 16
    l2_base_entries: int = 512
    l2_large_entries: int = 256
    l1_latency: int = 1
    l2_latency: int = 10
    # Page table walker.
    walker_slots: int = 64
    walk_levels: int = 4
    dram_latency: int = 160          # cycles per serialized walk access
    # Translation model (DESIGN.md §15).  "flat" charges every TLB miss a
    # constant ``walk_levels × dram_latency`` (the pre-§15 model, kept
    # verbatim — bitwise-identical timings).  "radix" routes misses
    # through :class:`repro_torch.core.ptw.RadixWalker` — per-level page-walk
    # caches skip already-cached upper levels — and replaces per-page TLB
    # entries with subregion-coalesced ones whose reach is derived from
    # the actual frame map the allocator produced (CoCoA's contiguity ⇒
    # one entry covers a run of pages; the oracle ``coalesced`` bit is
    # ignored).  With ``pwc_entries=0`` and ``coalesce_span=1`` radix is
    # cycle-identical to flat (the parity the ptw tests pin).
    translation: str = "flat"
    pwc_entries: int = 64            # per-level walk-cache entries (0 = off)
    pwc_latency: int = 2             # charged once when a PWC skips levels
    coalesce_span: int = 32          # subregion size in base pages (1 = flat
    #                                  per-page entries)
    radix_bits: int = 9              # index bits per radix level
    # Issue model.  One trace access is a *macro-access*: a warp's full dwell
    # on one 4KB page (it issues `page_repeat` memory instructions into that
    # page — cache-line iteration).  ``AppTrace.gap_cycles`` is the dwell
    # time; translation is looked up once per dwell, which is exactly how a
    # TLB behaves (the dwell's remaining accesses hit the same entry).
    warps_per_app: int = 32
    # Demand paging.
    paging: bool = True
    warm: bool = False               # True: working set pre-resident (steady state)
    page_bytes: int = 4096           # paper's base page
    # Trace-scale amortization: our simulated window is ~1/K of the interval
    # between kernel launches in the paper's billion-cycle runs, but cold
    # faults all land inside it.  Dividing fault cost by K restores the
    # fault-to-compute ratio of the full-length run (disclosed; swept in the
    # Fig. 7 benchmark with K=1 as the worst case).
    fault_amortize: int = 16
    # Host↔device DMA channels on the shared link (serving/dma.py's overlap
    # model, transplanted): 1 = the paper's single serialized bus; >1 lets
    # transfers of different apps proceed concurrently, shrinking the
    # cross-app interference the contention stats measure.
    dma_channels: int = 1
    # Full-duplex link (serving/dma.py's model, DESIGN.md §8): inbound
    # faults and outbound writebacks get independent per-channel
    # timelines; False degrades to half-duplex, where eviction traffic
    # queues against fault-ins on the same channels.
    duplex: bool = True
    # Device-memory cap per app in resident base pages (None = unbounded,
    # the paper's cold-fault-only model).  With a cap, a fault past the
    # cap evicts the app's LRU page first — an outbound writeback on the
    # link — so the sim generates the two-direction traffic the duplex
    # model distinguishes.
    hbm_pages_per_app: Optional[int] = None
    # Cluster tier (DESIGN.md §10): engines each own `dma_channels`
    # host↔device lanes (apps are striped app % n_engines), so per-engine
    # links remove cross-engine *link* contention — but with a shared
    # host tier every transfer must also occupy one of `host_lanes` host
    # DRAM lanes, the new shared bottleneck.  host_lanes=0 leaves the
    # host store unmodeled (pre-cluster behavior, and the default).
    n_engines: int = 1
    host_lanes: int = 0
    # Disk spill tier under the host store (DESIGN.md §11): each outbound
    # writeback, after its link transfer, streams from host DRAM to disk
    # on one of `disk_lanes` lanes at `disk_cycles_per_page` occupancy
    # (amortized by fault_amortize like every other per-page cost).
    # Disk is ~an order of magnitude slower than the link, so a burst of
    # evictions queues at the disk — the write-back back-pressure the
    # serving tier's bounded buffer models; `disk_contention_cycles`
    # measures exactly that queueing.  disk_lanes=0 leaves the disk
    # unmodeled (the default, pre-§11 behavior).
    disk_lanes: int = 0
    disk_cycles_per_page: float = 4000.0
    clock_ghz: float = 1.02          # shader clock (Table 1: 1020 MHz)
    link: LinkModel = dataclasses.field(default_factory=LinkModel)
    # Page-size mode: "mosaic" uses per-frame coalesced bits from the
    # allocator; "base" forces 4KB-only; "large" forces 2MB-only (Fig. 1's
    # GPU-MMU-2MB design: same entry *counts* as the 4KB design).
    mode: str = "mosaic"
    ideal: bool = False              # ideal TLB: every lookup hits in L1

    @property
    def walk_latency(self) -> int:
        return self.walk_levels * self.dram_latency

    def fault_cycles(self, nbytes: int) -> float:
        return self.link.transfer_us(nbytes) * self.clock_ghz * 1e3


# --------------------------------------------------------------------------- pieces


class LRU:
    """Fully-associative LRU cache of hashable tags."""

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
        # A never-touched cache has no hit rate; nan (not 1.0) keeps it
        # from reading as a perfect cache in bench tables.
        return self.hits / n if n else float("nan")


class Walker:
    """Shared page-table walker: ``slots`` concurrent walks, FIFO overflow."""

    def __init__(self, slots: int, walk_latency: int):
        self.slots = slots
        self.walk_latency = walk_latency
        self._busy: List[float] = []   # heap of finish times
        self.walks = 0
        self.stall_cycles = 0.0

    def start(self, now: float) -> float:
        """Returns the completion time of a walk requested at ``now``."""
        while self._busy and self._busy[0] <= now:
            heapq.heappop(self._busy)
        if len(self._busy) < self.slots:
            begin = now
        else:
            begin = heapq.heappop(self._busy)   # wait for a slot
            self.stall_cycles += begin - now
        finish = begin + self.walk_latency
        heapq.heappush(self._busy, finish)
        self.walks += 1
        return finish


class Link:
    """System I/O bus: bandwidth-serialized, setup-pipelined (demand paging).

    DMA setup overlaps with in-flight transfers (real PCIe queues many
    descriptors), so the bus *occupancy* per fault is bytes/bandwidth, while
    the faulting warp's *latency* additionally pays the setup cost.

    ``cfg.dma_channels`` transplants the serving engine's overlap model
    (:mod:`repro_torch.serving.dma`): each transfer rides the earliest-free
    channel, so with one channel the bus serializes exactly as in the
    paper, while extra channels let different apps' faults overlap.  The
    queueing delay a fault pays because the shared link is busy — almost
    always with *another* app's transfer in a multi-app run — is tracked
    per app in ``contention_cycles``.

    The link is **full-duplex** by default (``cfg.duplex``, DESIGN.md
    §8): outbound writebacks (capacity evictions under
    ``cfg.hbm_pages_per_app``) occupy their own per-channel timelines
    and contend only with each other (``contention_cycles_out``); with
    ``duplex=False`` both directions share one timeline, so eviction
    traffic queues *inbound* faults too — the half-duplex penalty the
    duplex benches measure.
    """

    def __init__(self, cfg: SimConfig, n_apps: int = 1):
        self.cfg = cfg
        n = max(1, cfg.dma_channels)
        E = max(1, cfg.n_engines)
        # Per-engine link lanes (DESIGN.md §10): engine e's inbound lanes
        # are _lanes_in[e]; a single-engine sim degenerates to the
        # pre-cluster model exactly.
        self._lanes_in = [[0.0] * n for _ in range(E)]
        # Half-duplex shares the same list objects (either direction's
        # transfer occupies the single per-channel timeline).
        self._lanes_out = [[0.0] * n for _ in range(E)] if cfg.duplex \
            else self._lanes_in
        # Legacy aliases (engine 0) so existing single-engine callers and
        # tests keep reading the same attributes.
        self.channel_busy = self._lanes_in[0]
        self.channel_busy_out = self._lanes_out[0]
        # Shared host-store DRAM lanes: every transfer of every engine,
        # both directions, must also book one (host DRAM bandwidth is
        # direction-agnostic).  Empty list = unmodeled.
        self._host_lanes = [0.0] * max(0, cfg.host_lanes)
        # Disk spill lanes under the host store (DESIGN.md §11): every
        # writeback streams on to disk after its link transfer.  Empty
        # list = unmodeled.
        self._disk_lanes = [0.0] * max(0, cfg.disk_lanes)
        self.faults = 0
        self.fault_cycles_total = 0.0
        self.contention_cycles = [0.0] * n_apps         # inbound, link
        self.writebacks = 0
        self.writeback_cycles_total = 0.0
        self.contention_cycles_out = [0.0] * n_apps
        # Queueing a transfer pays at the shared host store *after* its
        # link lane is free — the cluster-tier bottleneck stat.
        self.host_contention_cycles = [0.0] * n_apps
        # Writebacks that queued at the (slower) disk after their link
        # transfer — the §11 write-back saturation signal.
        self.disk_writebacks = 0
        self.disk_busy_cycles = 0.0
        self.disk_contention_cycles = [0.0] * n_apps

    @property
    def busy_until(self) -> float:
        return max(max(max(l) for l in self._lanes_in),
                   max(max(l) for l in self._lanes_out))

    def engine_occupancy(self, now: float, engine: int = 0) -> float:
        """Cost-model parity hook (DESIGN.md §14): one engine's modeled
        lane backlog, in cycles — booked time beyond ``now`` on the
        engine's own link lanes plus its share of the host-store and
        disk lanes.  This mirrors the link-/host-/disk-lane occupancy
        terms the serving router's modeled-µs dispatch cost charges, so
        the sim and the router agree (monotonically) on which engine is
        more loaded: booking more traffic on an engine's lanes can only
        raise its occupancy, never lower it.
        """
        e = engine % len(self._lanes_in)
        backlog = sum(max(0.0, t - now) for t in self._lanes_in[e])
        if self._lanes_out[e] is not self._lanes_in[e]:    # duplex only
            backlog += sum(max(0.0, t - now) for t in self._lanes_out[e])
        for shared in (self._host_lanes, self._disk_lanes):
            if shared:
                backlog += sum(max(0.0, t - now) for t in shared)
        return backlog

    def _occupy(self, lanes, now: float, transfer: float):
        ch = min(range(len(lanes)), key=lambda i: lanes[i])
        begin = max(now, lanes[ch])
        lanes[ch] = begin + transfer
        return begin

    def _book(self, lanes, now: float, transfer: float, app: int) -> float:
        """Occupy a link lane and, when modeled, a shared host-store
        lane; the transfer starts when *both* are free.  Returns the
        start time; host-store queueing beyond the link's own is
        attributed to ``host_contention_cycles``."""
        link_begin = self._occupy(lanes, now, transfer)
        if not self._host_lanes:
            return link_begin
        h = min(range(len(self._host_lanes)),
                key=lambda i: self._host_lanes[i])
        begin = max(link_begin, self._host_lanes[h])
        self._host_lanes[h] = begin + transfer
        if begin > link_begin:
            # The link lane sat idle waiting for host DRAM: re-point its
            # busy horizon at the true completion.
            ch = lanes.index(link_begin + transfer)
            lanes[ch] = begin + transfer
        if app < len(self.host_contention_cycles):
            self.host_contention_cycles[app] += begin - link_begin
        return begin

    def _costs(self):
        c = self.cfg
        k = max(1, c.fault_amortize)
        transfer = (c.page_bytes / (c.link.bandwidth_GBps * 1e9)) \
            * c.clock_ghz * 1e9 / k
        setup = c.link.setup_us * c.clock_ghz * 1e3 / k
        return transfer, setup

    def fault(self, now: float, app: int = 0, engine: int = 0) -> float:
        transfer, setup = self._costs()
        lanes = self._lanes_in[engine % len(self._lanes_in)]
        free_at = min(lanes)
        begin = self._book(lanes, now, transfer, app)
        fin = begin + setup + transfer              # faulting warp's latency
        self.faults += 1
        self.fault_cycles_total += fin - now
        if app < len(self.contention_cycles):
            self.contention_cycles[app] += max(free_at - now, 0.0)
        return fin

    def writeback(self, now: float, app: int = 0, engine: int = 0) -> float:
        """Outbound device→host eviction transfer.

        Write-back buffering keeps it off the faulting warp's critical
        path — the return value is the channel-occupancy end, not a warp
        stall — but the transfer occupies an "out" lane (or, when
        half-duplex, the shared lane, where it queues future faults) and,
        in a cluster, a shared host-store lane.
        """
        transfer, _setup = self._costs()
        lanes = self._lanes_out[engine % len(self._lanes_out)]
        free_at = min(lanes)
        begin = self._book(lanes, now, transfer, app)
        self.writebacks += 1
        self.writeback_cycles_total += begin + transfer - now
        if app < len(self.contention_cycles_out):
            self.contention_cycles_out[app] += max(free_at - now, 0.0)
        end = begin + transfer
        if self._disk_lanes:
            # §11 spill: after the link transfer lands in host DRAM the
            # frame streams on to disk.  Disk pages cost far more than
            # link pages, so the lane backlog — not the link — is what
            # stalls further evictions; that wait is the back-pressure
            # the serving tier's bounded write-back queue reacts to.
            disk_cost = self.cfg.disk_cycles_per_page \
                / max(1, self.cfg.fault_amortize)
            lane = min(range(len(self._disk_lanes)),
                       key=self._disk_lanes.__getitem__)
            dbegin = max(end, self._disk_lanes[lane])
            self._disk_lanes[lane] = dbegin + disk_cost
            self.disk_writebacks += 1
            self.disk_busy_cycles += disk_cost
            if app < len(self.disk_contention_cycles):
                self.disk_contention_cycles[app] += dbegin - end
            end = dbegin + disk_cost
        return end

    def contention_total(self) -> float:
        return float(sum(self.contention_cycles))

    def contention_out_total(self) -> float:
        return float(sum(self.contention_cycles_out))

    def host_contention_total(self) -> float:
        return float(sum(self.host_contention_cycles))

    def disk_contention_total(self) -> float:
        return float(sum(self.disk_contention_cycles))


# --------------------------------------------------------------------------- traces


@dataclasses.dataclass
class AppTrace:
    """A translated memory trace: per access, the physical tag info.

    vpn:        virtual page per access            int32[T]
    ppn:        physical page per access           int32[T]
    frame:      physical frame per access          int32[T]
    coalesced:  1 if the page's frame is coalesced int8[T]
    gap_cycles: per-app compute gap between a warp's accesses
    name:       profile name (for reporting)
    """

    vpn: np.ndarray
    ppn: np.ndarray
    frame: np.ndarray
    coalesced: np.ndarray
    gap_cycles: int
    name: str = "app"
    # Full vpn→ppn map of the app's address space (UNMAPPED = -1), as the
    # allocator produced it.  The radix model derives coalesced-entry
    # coverage from it; None falls back to the map induced by the trace
    # pairs themselves (sufficient for synthetic traces).
    ppn_map: Optional[np.ndarray] = None


# --------------------------------------------------------------------------- simulator


@dataclasses.dataclass
class AppResult:
    name: str
    retired: int
    cycles: float
    l1_hit: float
    l2_hit: float
    faults: int
    # Radix-walker accounting (DESIGN.md §15); zeros/nan under the flat
    # model, which only tracks walker-wide totals.
    walks: int = 0
    walk_cycles: float = 0.0         # latency past the L2 miss, summed
    walk_queue_cycles: float = 0.0   # slot-queue wait (walker interference)
    pwc_hit: float = float("nan")    # walk-cache hit rate of the app's walker

    @property
    def ipc(self) -> float:
        return self.retired / max(self.cycles, 1.0)


class TranslationSim:
    """Event-driven multi-application TLB/paging simulator."""

    def __init__(self, cfg: SimConfig, apps: Sequence[AppTrace]):
        if cfg.translation not in ("flat", "radix"):
            raise ValueError(
                f"SimConfig.translation must be 'flat' or 'radix', "
                f"got {cfg.translation!r}")
        self.cfg = cfg
        self.apps = list(apps)
        n = len(self.apps)
        # Private-per-app L1s; shared L2, walker, link (paper Table 1).
        self.l1_base = [LRU(cfg.l1_base_entries) for _ in range(n)]
        self.l1_large = [LRU(cfg.l1_large_entries) for _ in range(n)]
        self.l2_base = LRU(cfg.l2_base_entries)
        self.l2_large = LRU(cfg.l2_large_entries)
        self.walker = Walker(cfg.walker_slots, cfg.walk_latency)
        self.link = Link(cfg, n_apps=n)
        if cfg.translation == "radix":
            from repro_torch.core.ptw import (CoalescedTLB, RadixWalker,
                                        subregion_entry)
            self._mk_entry = subregion_entry
            span = max(1, cfg.coalesce_span)
            # One coalesced entry replaces a base+large entry pair: give
            # the coalesced arrays the combined entry budget so radix
            # isn't quietly handed extra capacity.
            self.l1_co = [
                CoalescedTLB(cfg.l1_base_entries + cfg.l1_large_entries,
                             span)
                for _ in range(n)]
            self.l2_co = CoalescedTLB(
                cfg.l2_base_entries + cfg.l2_large_entries, span)
            # Per-engine walkers (the cluster tier gives each engine its
            # own MMU, like its own link lanes); single-engine degenerates
            # to one shared walker.  ``self.walker`` above still exists
            # but never starts a walk in radix mode; ``self.walkers`` is
            # the accounting surface.
            E = max(1, cfg.n_engines)
            self.walkers = [
                RadixWalker(cfg.walker_slots, cfg.walk_levels,
                            cfg.dram_latency, pwc_entries=cfg.pwc_entries,
                            pwc_latency=cfg.pwc_latency, bits=cfg.radix_bits,
                            n_apps=n)
                for _ in range(E)]
            # Per-app vpn→ppn maps drive coalesced-entry coverage: the
            # allocator's own map when the trace carries one, else the
            # map induced by the trace's (vpn, ppn) pairs.
            self.ppn_maps: List[np.ndarray] = []
            for tr in self.apps:
                if tr.ppn_map is not None:
                    self.ppn_maps.append(
                        np.asarray(tr.ppn_map, dtype=np.int64))
                else:
                    size = int(tr.vpn.max()) + 1 if len(tr.vpn) else 1
                    m = np.full(size, -1, dtype=np.int64)
                    m[tr.vpn] = tr.ppn
                    self.ppn_maps.append(m)
        # Per-app resident pages in LRU order (OrderedDict preserves the
        # set-like membership tests while supporting capacity eviction).
        self.resident: List[OrderedDict] = [OrderedDict() for _ in range(n)]
        self.fault_count = [0] * n
        self.mshr: Dict[Tuple[int, int, bool], float] = {}

    # -- one translation ---------------------------------------------------------

    def _translate_radix(self, now: float, app: int, i: int) -> float:
        """Radix path (DESIGN.md §15): subregion-coalesced L1/L2 lookup,
        then a multi-level walk on the app's engine's walker.  Tags come
        from the *virtual* subregion — the page-size ``mode`` and the
        oracle ``coalesced`` bit are ignored; an entry's reach is however
        much contiguity the allocator actually preserved in the frame
        map."""
        cfg = self.cfg
        tr = self.apps[app]
        vpn = int(tr.vpn[i])
        span = max(1, cfg.coalesce_span)
        sreg, off = divmod(vpn, span)
        l1 = self.l1_co[app]
        if l1.lookup(sreg, off) is not None:
            return now + cfg.l1_latency
        e = self.l2_co.lookup((app, sreg), off)
        if e is not None:
            l1.insert(sreg, e)
            return now + cfg.l1_latency + cfg.l2_latency
        t0 = now + cfg.l1_latency + cfg.l2_latency
        walker = self.walkers[app % len(self.walkers)]
        done = walker.walk(now, t0, app, vpn, (app, sreg))
        entry = self._mk_entry(self.ppn_maps[app], vpn, span)
        self.l2_co.insert((app, sreg), entry)
        l1.insert(sreg, entry)
        return done

    def splinter(self, app: int, vpn: int,
                 new_ppn: Optional[int] = None) -> None:
        """CoCoA splintered/remapped one page: update the app's frame map
        and invalidate only the touched subregion's coalesced entries.
        PWCs are untouched — the upper-level radix entries still point at
        the same intermediate tables (hardware-faithful selectivity the
        ptw property tests pin)."""
        if self.cfg.translation != "radix":
            return
        if new_ppn is not None:
            m = self.ppn_maps[app]
            if vpn >= len(m):
                grown = np.full(vpn + 1, -1, dtype=np.int64)
                grown[: len(m)] = m
                self.ppn_maps[app] = m = grown
            m[vpn] = new_ppn
        sreg = vpn // max(1, self.cfg.coalesce_span)
        self.l1_co[app].invalidate(sreg)
        self.l2_co.invalidate((app, sreg))

    def translate(self, now: float, app: int, i: int) -> float:
        """Returns the cycle at which the translation (and fault) resolves."""
        cfg = self.cfg
        tr = self.apps[app]
        if cfg.translation == "radix" and not cfg.ideal:
            done = self._translate_radix(now, app, i)
            return self._page_in(done, now, app, i)
        if cfg.mode == "large":
            large = True
        elif cfg.mode == "base":
            large = False
        else:
            large = bool(tr.coalesced[i])
        tag = int(tr.frame[i]) if large else int(tr.ppn[i])

        if cfg.ideal:
            done = now + cfg.l1_latency
        else:
            l1 = (self.l1_large if large else self.l1_base)[app]
            l2 = self.l2_large if large else self.l2_base
            if l1.lookup(tag):
                done = now + cfg.l1_latency
            elif l2.lookup((app, tag)):
                l1.insert(tag)
                done = now + cfg.l1_latency + cfg.l2_latency
            else:
                key = (app, tag, large)
                t0 = now + cfg.l1_latency + cfg.l2_latency
                if key in self.mshr and self.mshr[key] > now:
                    done = self.mshr[key]       # merged into in-flight walk
                else:
                    done = self.walker.start(t0)
                    self.mshr[key] = done
                l2.insert((app, tag))
                l1.insert(tag)

        return self._page_in(done, now, app, i)

    def _page_in(self, done: float, now: float, app: int, i: int) -> float:
        """Demand paging: first touch of a base page faults it in.
        (Transfers are always base-page-granular — Mosaic's point; the
        *translation* above may still be large.)  Under an HBM capacity
        cap, faulting past the cap first writes the LRU resident page
        back to host — outbound traffic on the (duplex) link.  Shared
        verbatim by the flat and radix translation paths."""
        cfg = self.cfg
        tr = self.apps[app]
        if cfg.paging and not cfg.warm:
            ppn = int(tr.ppn[i])
            res = self.resident[app]
            # Cluster striping (DESIGN.md §10): app a runs on engine
            # a % n_engines and uses that engine's link lanes.
            engine = app % max(1, cfg.n_engines)
            if ppn in res:
                res.move_to_end(ppn)
            else:
                cap = cfg.hbm_pages_per_app
                if cap is not None and len(res) >= cap:
                    res.popitem(last=False)         # evict LRU
                    self.link.writeback(now, app, engine)
                res[ppn] = True
                self.fault_count[app] += 1
                done = max(done, self.link.fault(now, app, engine))
        return done

    # -- main loop -----------------------------------------------------------------

    def run(self, max_accesses: Optional[int] = None) -> List[AppResult]:
        cfg = self.cfg
        W = cfg.warps_per_app
        events: List[Tuple[float, int, int, int]] = []  # (time, app, warp, idx)
        ptr_step = W
        for a, tr in enumerate(self.apps):
            T = len(tr.vpn) if max_accesses is None else min(len(tr.vpn), max_accesses)
            for w in range(min(W, T)):
                heapq.heappush(events, (float(w % 7), a, w, w))
        retired = [0] * len(self.apps)
        finish_time = [0.0] * len(self.apps)
        lengths = [
            len(tr.vpn) if max_accesses is None else min(len(tr.vpn), max_accesses)
            for tr in self.apps
        ]
        while events:
            now, a, w, i = heapq.heappop(events)
            done = self.translate(now, a, i)
            retired[a] += 1
            finish_time[a] = max(finish_time[a], done)
            nxt = i + ptr_step
            if nxt < lengths[a]:
                heapq.heappush(
                    events, (done + self.apps[a].gap_cycles, a, w, nxt)
                )
        out = []
        radix = cfg.translation == "radix"
        for a, tr in enumerate(self.apps):
            if radix:
                h, m = self.l1_co[a].hits, self.l1_co[a].misses
                wk = self.walkers[a % len(self.walkers)]
                extra = dict(
                    walks=wk.app_walks[a],
                    walk_cycles=wk.app_walk_cycles[a],
                    walk_queue_cycles=wk.app_queue_cycles[a],
                    pwc_hit=wk.pwc_hit_rate(),
                )
            else:
                l1 = self.l1_base[a], self.l1_large[a]
                h = sum(x.hits for x in l1)
                m = sum(x.misses for x in l1)
                extra = {}
            out.append(
                AppResult(
                    name=tr.name,
                    retired=retired[a],
                    cycles=finish_time[a],
                    l1_hit=h / max(h + m, 1),
                    l2_hit=0.0,  # filled by caller from shared L2 (per-sim)
                    # Fault *events* — equals the resident-set size only
                    # while hbm_pages_per_app is uncapped (no re-faults).
                    faults=self.fault_count[a],
                    **extra,
                )
            )
        return out

    def l2_hit_rate(self) -> float:
        if self.cfg.translation == "radix":
            return self.l2_co.hits / max(self.l2_co.hits
                                         + self.l2_co.misses, 1)
        h = self.l2_base.hits + self.l2_large.hits
        m = self.l2_base.misses + self.l2_large.misses
        return h / max(h + m, 1)

    def l1_hit_rate(self) -> float:
        if self.cfg.translation == "radix":
            h = sum(t.hits for t in self.l1_co)
            m = sum(t.misses for t in self.l1_co)
            return h / max(h + m, 1)
        h = sum(x.hits for x in self.l1_base) + sum(x.hits for x in self.l1_large)
        m = sum(x.misses for x in self.l1_base) + sum(x.misses for x in self.l1_large)
        return h / max(h + m, 1)

    # -- radix-only accounting (DESIGN.md §15) -------------------------------

    def total_walks(self) -> int:
        if self.cfg.translation == "radix":
            return sum(w.walks for w in self.walkers)
        return self.walker.walks

    def total_walk_cycles(self) -> float:
        """Summed per-app walk latency past the L2 miss (radix), or the
        flat model's constant-cost equivalent."""
        if self.cfg.translation == "radix":
            return float(sum(sum(w.app_walk_cycles) for w in self.walkers))
        return float(self.walker.walks * self.cfg.walk_latency
                     + self.walker.stall_cycles)

    def walker_queue_cycles(self) -> float:
        if self.cfg.translation == "radix":
            return float(sum(w.stall_cycles for w in self.walkers))
        return float(self.walker.stall_cycles)

    def pwc_hit_rate(self) -> float:
        if self.cfg.translation != "radix":
            return float("nan")
        h = sum(p.hits for w in self.walkers for p in w.pwcs)
        m = sum(p.misses for w in self.walkers for p in w.pwcs)
        return h / (h + m) if h + m else float("nan")

    def walk_dram_accesses(self) -> int:
        if self.cfg.translation == "radix":
            return sum(w.dram_accesses() for w in self.walkers)
        return self.walker.walks * self.cfg.walk_levels

    def l1_hit_rate_micro(self, page_repeat: int = 24) -> float:
        """Per-memory-instruction L1 hit rate.

        The simulator looks up the TLB once per *page dwell*; the remaining
        ``page_repeat - 1`` instructions of the dwell hit the just-filled
        entry by construction.  This converts dwell-level rates to the
        instruction-level rates the paper reports (Fig. 8).
        """
        h = sum(x.hits for x in self.l1_base) + sum(x.hits for x in self.l1_large)
        m = sum(x.misses for x in self.l1_base) + sum(x.misses for x in self.l1_large)
        n = h + m
        if n == 0:
            return 1.0
        return (h + (page_repeat - 1) * n) / (page_repeat * n)

    def l2_hit_rate_micro(self, page_repeat: int = 24) -> float:
        """Per-instruction L2 rate among L2 lookups (L1-dwell misses only).

        L2 is only consulted on an L1 miss, and dwell-internal reuse never
        reaches it, so the dwell-level rate *is* the instruction-level rate.
        Kept as a named helper for symmetry/reporting clarity.
        """
        del page_repeat
        return self.l2_hit_rate()


# --------------------------------------------------------------------------- metrics


def weighted_speedup(
    shared: Sequence[AppResult], alone: Sequence[AppResult]
) -> float:
    """Paper Eq. (1): Σ IPC_shared / IPC_alone."""
    assert len(shared) == len(alone)
    return float(sum(s.ipc / max(al.ipc, 1e-12) for s, al in zip(shared, alone)))
