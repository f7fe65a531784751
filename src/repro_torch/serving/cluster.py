"""Cluster serving tier: N engine replicas over one shared host tier.

Mosaic's core invariant — a large frame holds base pages of **one**
memory protection domain, so contiguity survives without migration — has
so far lived inside a single :class:`~repro_torch.serving.engine.ServingEngine`.
This module lifts it to the cluster level (DESIGN.md §10): several engine
replicas (one per accelerator) share one process-wide host DRAM tier, and
the *host* large frames obey the same single-domain rule via per-engine
**frame leases**:

* :class:`HostFrameTable` — places every parked page payload into a host
  frame of ``frame_pages`` slots.  A frame is leased to exactly one
  protection domain (an engine id, or the shared prefix-cache domain);
  pages of different domains never share a frame, and a frame whose last
  page leaves is returned whole to the free pool (the soft guarantee,
  host-side).  ``migrate()`` re-leases a request's pages to another
  domain — flipping the owner of exclusively-held frames outright, and
  re-placing only the pages of mixed frames — which is the entire data
  cost of moving a request between engines: host-side bookkeeping, zero
  device↔device traffic.
* :class:`LeasedStoreView` — the :class:`~repro_torch.serving.host_tier.
  HostPageStore` facade each engine (and the prefix index) holds: same
  interface, one shared store underneath, every put/pop/discard
  mirrored into the frame table under the view's domain.
* :class:`SharedHostTier` — one ``HostPageStore`` + one
  :class:`~repro_torch.serving.host_tier.PrefixIndex` (or per-engine indexes
  with disjoint owner namespaces, for the A/B bench) + the frame table.
* :class:`ServingCluster` — builds the replicas (shared params, so all
  replicas are bitwise-identical models), wires them to the tier and to
  the deadline-aware :class:`~repro_torch.serving.router.RequestRouter`, and
  aggregates :class:`ClusterStats`.

Cross-engine prefix sharing falls out for free: the index's payloads
live under negative owner ids in the *shared* store, and page locations
``(shard, vpn)`` are deterministic per geometry, so a prefix parked by
replica 0 faults into replica 1's pool through replica 1's own DMA
lanes.  Work-stealing migration (router) hands a preempted request to an
idle replica by re-leasing its host frames — the request resumes there
with **zero re-prefill**, exactly the paper's "no costly base page
migration" story at cluster scale.

Request ids must be unique cluster-wide (the shared store keys payloads
by ``(rid, shard, vpn)``); the frame table asserts double-placement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PoolGeometry
from repro_torch.core.demand_paging import LinkModel
from repro_torch.serving.dma import AsyncDMAEngine
from repro_torch.serving.engine import EngineStats, Request, ServingEngine
from repro_torch.serving.faults import (FaultInjector, SpillCorruptionError,
                                  SpillIOError)
from repro_torch.serving.host_tier import HostPageStore, PrefixIndex, SpillStore
from repro_torch.serving.router import RequestRouter, RouterStats

Key = Tuple[int, int, int]          # (seq, shard, local vpn)
Domain = Hashable                   # engine id, or ("prefix", …)

PREFIX_DOMAIN: Domain = "prefix"

# Host-frame state machine (DESIGN.md §11).  A frame's payloads live in
# host DRAM while HOST or PENDING_WRITE_BACK (the write-back buffer holds
# a snapshot *reference*, not a copy — reads stay free until the frame
# actually lands on disk) and on disk while SPILLED.
FRAME_HOST = "host"
FRAME_PENDING_WB = "pending_write_back"
FRAME_SPILLED = "spilled"


class HostFrameTable:
    """Host-DRAM frame leases: the single-domain-per-frame rule, lifted.

    Frames are numbered from 0 and hold ``frame_pages`` page slots each.
    ``place(domain, key)`` finds (or leases) a frame of that domain with
    a free slot; ``release(key)`` frees the slot and returns the frame
    whole to the free pool when it empties — so, as in CoCoA, frames
    recycle at frame granularity and never fragment across domains.

    With a disk tier underneath (DESIGN.md §11) every frame also carries
    a state — ``FRAME_HOST`` → ``FRAME_PENDING_WB`` → ``FRAME_SPILLED``
    → (promote) ``FRAME_HOST`` — and an LRU tick refreshed by placements
    and touches; ``capacity_frames`` is the host-DRAM bound the owning
    :class:`SharedHostTier` enforces by spilling the LRU victim.  Only
    ``FRAME_HOST`` frames accept placements (pending/spilled frames are
    withdrawn from the open sets), and a spilled frame must be promoted
    before any of its pages is released.
    """

    def __init__(self, frame_pages: int,
                 capacity_frames: Optional[int] = None,
                 victim_scoring: str = "lru") -> None:
        assert frame_pages >= 1
        assert capacity_frames is None or capacity_frames >= 1
        if victim_scoring not in ("lru", "cost"):
            raise ValueError(f"victim_scoring must be 'lru' or 'cost', "
                             f"got {victim_scoring!r}")
        self.frame_pages = frame_pages
        self.capacity_frames = capacity_frames
        self.victim_scoring = victim_scoring
        self._key_frame: Dict[Key, int] = {}
        self._frame_keys: Dict[int, Set[Key]] = {}
        self._frame_owner: Dict[int, Domain] = {}
        self._open: Dict[Domain, Set[int]] = {}   # leased, ≥1 free slot
        self._free: List[int] = []                # recycled frame ids
        self._next = 0
        self._state: Dict[int, str] = {}          # leased frame → FRAME_*
        self._frame_tick: Dict[int, int] = {}     # LRU clock per frame
        self._tick = 0
        self._frame_hits: Dict[int, int] = {}     # touches since lease
        self.stats = {
            "frames_leased": 0, "frames_recycled": 0, "peak_frames": 0,
            "placed_pages": 0, "page_moves": 0, "whole_frame_moves": 0,
            "spilled_frames": 0, "promoted_frames": 0, "spill_cancels": 0,
        }

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self._frame_owner)

    def owner_of(self, key: Key) -> Optional[Domain]:
        f = self._key_frame.get(key)
        return None if f is None else self._frame_owner[f]

    def frames_of(self, domain: Domain) -> int:
        return sum(1 for d in self._frame_owner.values() if d == domain)

    def frame_of(self, key: Key) -> Optional[int]:
        return self._key_frame.get(key)

    def keys_of(self, frame: int) -> Set[Key]:
        return set(self._frame_keys.get(frame, ()))

    def state_of(self, frame: int) -> Optional[str]:
        return self._state.get(frame)

    def resident_frames(self) -> int:
        """Frames whose payloads occupy host DRAM (HOST + PENDING_WB)."""
        return sum(1 for s in self._state.values() if s != FRAME_SPILLED)

    def spill_victim(self, exclude: Set[int] = frozenset(),
                     owner_ok=None) -> Optional[int]:
        """Pick the ``FRAME_HOST`` frame to spill, outside ``exclude``
        (``owner_ok``: optional domain predicate — the hard-capped tier
        restricts victims to prefix-cache domains).

        ``victim_scoring="lru"`` (baseline): least-recently-touched.
        ``victim_scoring="cost"`` (ROADMAP spill follow-on): minimize
        hit-frequency × promote cost — a rarely-touched frame that is
        also cheap to bring back (few occupied pages ⇒ a short disk
        read on promote) carries the least expected future stall.  The
        LRU tick breaks score ties so the policies agree on cold sets.
        """
        cands = [f for f, s in self._state.items()
                 if s == FRAME_HOST and f not in exclude
                 and (owner_ok is None or owner_ok(self._frame_owner[f]))]
        if not cands:
            return None
        if self.victim_scoring == "cost":
            return min(cands, key=lambda f: (
                self._frame_hits.get(f, 0)
                * (1 + len(self._frame_keys.get(f, ()))),
                self._frame_tick.get(f, 0), f))
        return min(cands, key=lambda f: (self._frame_tick.get(f, 0), f))

    # ------------------------------------------------------------- mutate

    def _touch_frame(self, f: int) -> None:
        self._tick += 1
        self._frame_tick[f] = self._tick
        self._frame_hits[f] = self._frame_hits.get(f, 0) + 1

    def touch(self, key: Key) -> Optional[str]:
        """Refresh the LRU tick of ``key``'s frame; returns its state."""
        f = self._key_frame.get(key)
        if f is None:
            return None
        self._touch_frame(f)
        return self._state[f]

    def _lease(self, domain: Domain) -> int:
        if self._free:
            f = self._free.pop()            # LIFO: reuse hot frame ids
        else:
            f = self._next
            self._next += 1
        self._frame_owner[f] = domain
        self._frame_keys[f] = set()
        self._open.setdefault(domain, set()).add(f)
        self._state[f] = FRAME_HOST
        self._frame_hits[f] = 0       # recycled ids must not inherit heat
        self._touch_frame(f)
        self.stats["frames_leased"] += 1
        self.stats["peak_frames"] = max(self.stats["peak_frames"],
                                        len(self._frame_owner))
        return f

    def place(self, domain: Domain, key: Key) -> int:
        """Assign ``key`` a slot in a frame of ``domain``; returns the
        frame id.  Placing an already-placed key is an error — it would
        mean two engines parked the same ``(rid, shard, vpn)``, i.e. a
        cluster-wide rid collision."""
        assert key not in self._key_frame, \
            f"host page {key} already placed (cluster-wide rid collision?)"
        open_frames = self._open.setdefault(domain, set())
        f = min(open_frames) if open_frames else self._lease(domain)
        self._frame_keys[f].add(key)
        self._key_frame[key] = f
        if len(self._frame_keys[f]) >= self.frame_pages:
            open_frames.discard(f)
        self._touch_frame(f)
        self.stats["placed_pages"] += 1
        return f

    def release(self, key: Key) -> None:
        f = self._key_frame.pop(key, None)
        if f is None:
            return                          # never placed (private store)
        assert self._state[f] != FRAME_SPILLED, \
            f"release of spilled page {key} — promote the frame first"
        keys = self._frame_keys[f]
        keys.discard(key)
        domain = self._frame_owner[f]
        if not keys:                        # whole-frame return
            st = self._state.pop(f)
            assert st == FRAME_HOST, \
                f"frame {f} recycled while {st} (cancel the write-back)"
            del self._frame_keys[f]
            del self._frame_owner[f]
            self._frame_tick.pop(f, None)
            self._frame_hits.pop(f, None)
            self._open.get(domain, set()).discard(f)
            self._free.append(f)
            self.stats["frames_recycled"] += 1
        elif self._state[f] == FRAME_HOST:
            self._open.setdefault(domain, set()).add(f)

    # ------------------------------------------------------- spill states

    def mark_pending_writeback(self, f: int) -> None:
        """HOST → PENDING_WB: the frame joins the write-back buffer and
        stops accepting placements (it is about to leave DRAM)."""
        assert self._state[f] == FRAME_HOST, (f, self._state[f])
        self._state[f] = FRAME_PENDING_WB
        self._open.get(self._frame_owner[f], set()).discard(f)

    def cancel_writeback(self, f: int) -> None:
        """PENDING_WB → HOST: a touch (or emptying) beat the disk."""
        assert self._state[f] == FRAME_PENDING_WB, (f, self._state[f])
        self._state[f] = FRAME_HOST
        self._touch_frame(f)
        if len(self._frame_keys[f]) < self.frame_pages:
            self._open.setdefault(self._frame_owner[f], set()).add(f)
        self.stats["spill_cancels"] += 1

    def mark_spilled(self, f: int) -> None:
        """PENDING_WB → SPILLED: the whole frame landed on disk."""
        assert self._state[f] == FRAME_PENDING_WB, (f, self._state[f])
        self._state[f] = FRAME_SPILLED
        self.stats["spilled_frames"] += 1

    def promote(self, f: int) -> None:
        """SPILLED → HOST: the frame's payloads are back in DRAM."""
        assert self._state[f] == FRAME_SPILLED, (f, self._state[f])
        self._state[f] = FRAME_HOST
        self._touch_frame(f)
        if len(self._frame_keys[f]) < self.frame_pages:
            self._open.setdefault(self._frame_owner[f], set()).add(f)
        self.stats["promoted_frames"] += 1

    # ------------------------------------------------------------ migrate

    def migrate(self, keys: Sequence[Key], dst: Domain) -> int:
        """Re-lease ``keys`` (one request's host pages) to ``dst``.

        A frame every one of whose pages is migrating just flips its
        owner — the whole-frame handoff, zero data movement even in
        host DRAM.  Pages sharing a frame with a non-migrating tenant
        are re-placed into ``dst`` frames (a host-side memcpy in the
        model; still no device traffic).  Returns the number of pages
        actually re-leased: keys that were never placed (stale bundle
        entries) and keys already in ``dst`` frames don't count, so
        migration stats never overcount.  Spilled frames must be
        promoted before their pages migrate (the caller's job — the
        on-disk file records a single domain).
        """
        moved = 0
        by_frame: Dict[int, List[Key]] = {}
        for k in keys:
            f = self._key_frame.get(k)
            if f is not None:
                by_frame.setdefault(f, []).append(k)
        for f, ks in sorted(by_frame.items()):
            src = self._frame_owner[f]
            assert self._state[f] != FRAME_SPILLED, \
                f"migrating pages of spilled frame {f} — promote first"
            if src == dst:
                continue
            if set(ks) == self._frame_keys[f]:
                self._frame_owner[f] = dst
                if f in self._open.get(src, set()):
                    self._open[src].discard(f)
                    self._open.setdefault(dst, set()).add(f)
                self.stats["whole_frame_moves"] += 1
            else:
                for k in ks:
                    self.release(k)
                    self.place(dst, k)
                    self.stats["page_moves"] += 1
            moved += len(ks)
        return moved

    # ------------------------------------------------------------- checks

    def check_invariants(self) -> None:
        for f, keys in self._frame_keys.items():
            assert f in self._frame_owner, f"frame {f} leased to nobody"
            assert 0 < len(keys) <= self.frame_pages, \
                f"frame {f} slot count {len(keys)}"
            assert self._state.get(f) in (FRAME_HOST, FRAME_PENDING_WB,
                                          FRAME_SPILLED), \
                f"frame {f} in unknown state {self._state.get(f)}"
            for k in keys:
                assert self._key_frame.get(k) == f, (k, f)
        assert set(self._state) == set(self._frame_owner)
        for domain, frames in self._open.items():
            for f in frames:
                assert self._frame_owner.get(f) == domain, \
                    f"open frame {f} not owned by {domain}"
                assert len(self._frame_keys[f]) < self.frame_pages
                # Only DRAM-resident, not-yet-queued frames accept
                # placements (§11 state machine).
                assert self._state[f] == FRAME_HOST, (f, self._state[f])
        # The invariant this whole class exists for: every placed page's
        # frame is leased to exactly one domain (structural here — the
        # dict can't hold two owners — but place() is the only write).
        assert len(self._key_frame) == sum(
            len(ks) for ks in self._frame_keys.values())


class LeasedStoreView:
    """Per-domain facade over the shared :class:`HostPageStore`.

    Same interface as the store (engines and the prefix index are
    oblivious), with every payload movement mirrored into the frame
    table under this view's protection domain.  Queries and stats
    delegate to the shared store — all views see all payloads (the
    point: a prefix parked by one engine is readable by every other),
    but each *write* lands in this domain's frames only.

    When the owning :class:`SharedHostTier` has a disk tier (``tier`` is
    set, DESIGN.md §11) every access is routed through the tier's hooks:
    reads promote spilled frames back to DRAM (promote-on-touch) and
    refresh the LRU tick, removals cancel a pending write-back whose
    frame they would empty, and writes trigger capacity enforcement.
    A ``tier=None`` view behaves exactly as before — zero overhead for
    clusters without a capacity bound.
    """

    def __init__(self, store: HostPageStore, frames: HostFrameTable,
                 domain: Domain, tier: "Optional[SharedHostTier]" = None
                 ) -> None:
        self.store = store
        self.frames = frames
        self.domain = domain
        self.tier = tier

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self.store)

    @property
    def stats(self) -> dict:
        return self.store.stats

    @property
    def _pages(self):
        return self.store._pages

    def has(self, seq: int, shard: int, vpn: int) -> bool:
        if self.store.has(seq, shard, vpn):
            return True
        return self.tier is not None \
            and self.tier.is_spilled((seq, shard, vpn))

    def seq_pages(self, seq: int) -> List[Key]:
        if self.tier is not None:
            return self.tier.seq_pages(seq)
        return self.store.seq_pages(seq)

    def nbytes(self) -> int:
        return self.store.nbytes()

    def request_pages(self) -> int:
        return self.store.request_pages()

    def peek(self, seq: int, shard: int, vpn: int):
        if self.tier is not None:
            self.tier.before_read((seq, shard, vpn))
        return self.store.peek(seq, shard, vpn)

    # ------------------------------------------------------------- movement

    def put(self, seq: int, shard: int, vpn: int, k_page, v_page, *,
            kind: str = "swap") -> None:
        key = (seq, shard, vpn)
        if self.tier is not None:
            self.tier.before_write(key)
        if not self.store.has(seq, shard, vpn):
            self.frames.place(self.domain, key)
        self.store.put(seq, shard, vpn, k_page, v_page, kind=kind)
        if self.tier is not None:
            self.tier.after_put(key)

    def pop(self, seq: int, shard: int, vpn: int):
        key = (seq, shard, vpn)
        if self.tier is not None:
            self.tier.before_remove(key)
        kv = self.store.pop(seq, shard, vpn)
        self.frames.release(key)
        return kv

    def discard(self, seq: int, shard: int, vpn: int) -> bool:
        key = (seq, shard, vpn)
        if self.tier is not None:
            self.tier.before_remove(key)
        if self.store.discard(seq, shard, vpn):
            self.frames.release(key)
            return True
        return False

    def drop_seq(self, seq: int) -> int:
        if self.tier is not None:
            # Promote the sequence's spilled frames first: a dropped key
            # must leave the frame table, and spilled frames may hold
            # surviving co-tenants (promote, then release normally).
            self.tier.ensure_resident(self.tier.spilled_keys_of(seq))
        keys = self.store.seq_pages(seq)
        n = self.store.drop_seq(seq)
        for k in keys:
            if self.tier is not None:
                self.tier.before_remove(k)
            self.frames.release(k)
        return n

    # -------------------------------------------------------- tier hooks
    # Mirrors HostPageStore's no-op surface so engines can call these on
    # whichever host they hold (DESIGN.md §11).

    def park_allowed(self) -> bool:
        return True if self.tier is None else self.tier.park_allowed()

    def ensure_resident(self, keys, now_us: Optional[float] = None
                        ) -> float:
        if self.tier is None:
            return 0.0
        return self.tier.ensure_resident(keys, now_us)

    def take_lost(self, seq: int) -> bool:
        return False if self.tier is None else self.tier.take_lost(seq)

    def pump(self, now_us: float) -> None:
        if self.tier is not None:
            self.tier.pump(now_us)

    def note_swap_out(self) -> None:
        self.store.note_swap_out()

    def note_swap_in(self) -> None:
        self.store.note_swap_in()


class SharedHostTier:
    """One host DRAM tier for the whole cluster: shared payload store,
    frame leases, and the prefix index (shared by default; per-engine
    indexes with disjoint owner namespaces when ``share_prefix=False``
    — the A/B the ``cluster`` bench measures).

    With ``capacity_frames`` set, host DRAM is *bounded* and a third,
    disk-backed tier opens underneath (DESIGN.md §11):

    * **Spill** (``spill=True``): when DRAM-resident frames exceed the
      bound, the LRU ``FRAME_HOST`` victim enters the write-back buffer
      — its pages ride the outbound DMA lanes as one contiguous
      ``kind="spill"`` job (whole frame ⇒ one descriptor), then stream
      to disk at the modeled seek + per-page write cost.  :meth:`pump`
      (called by every engine step with the modeled clock) persists
      frames whose write-back completed: payloads leave the store, the
      whole frame lands as one :class:`SpillStore` file, and the frame
      turns ``FRAME_SPILLED``.  Any touch before persistence cancels
      the write-back (the data never left DRAM); a touch after it
      promotes the whole frame back synchronously, charging the
      modeled disk-read stall to the toucher (promote-on-touch).
      The write-back buffer is bounded (``wb_queue_frames``): while it
      is full, :meth:`park_allowed` goes False and engines *refuse*
      new prefix parks instead of queueing unbounded dirty data —
      the back-pressure rule.
    * **Hard cap** (``spill=False``, the bench baseline): over-capacity
      prefix-cache frames are simply evicted *through* their index
      (:meth:`PrefixIndex.evict_owner_pages` keeps index↔store
      consistent).  Request-owned frames are never dropped — their
      payloads are not reconstructible — so only cache hit rate pays.

    **Failure handling** (DESIGN.md §12, with a :class:`~repro_torch.serving.
    faults.FaultInjector` wired in): transient disk errors on the spill
    path are retried up to ``disk_retries`` times with exponential
    backoff charged to the tier clock; a frame whose read fails
    permanently — or whose payload fails checksum verification — is
    *quarantined*: its file is destroyed, prefix payloads are evicted
    through their index (future matches re-derive via suffix
    re-prefill) and request sequences are marked **lost** so the owning
    engine restarts them from the prompt (:meth:`take_lost`).  When the
    observed disk error rate crosses ``disk_error_rate_threshold`` the
    tier *degrades*: all queued write-backs are cancelled (their data
    never left DRAM) and the tier drops to the hard-cap path — already-
    spilled frames stay promotable, no request is dropped.
    :meth:`reclaim_domain` recycles a dead engine's frames whole.
    """

    def __init__(self, geometry: PoolGeometry, *, n_engines: int,
                 share_prefix: bool = True,
                 prefix_capacity_pages: int = 4096,
                 capacity_frames: Optional[int] = None,
                 spill: bool = True,
                 spill_dir: Optional[str] = None,
                 wb_queue_frames: int = 4,
                 wb_lanes: int = 1,
                 disk_read_us_per_page: float = 25.0,
                 disk_write_us_per_page: float = 25.0,
                 disk_seek_us: float = 100.0,
                 link: Optional[LinkModel] = None,
                 injector: Optional[FaultInjector] = None,
                 disk_retries: int = 3,
                 retry_backoff_us: float = 50.0,
                 disk_error_rate_threshold: float = 0.5,
                 victim_scoring: str = "lru",
                 undegrade_probe_interval_us: Optional[float] = 10_000.0,
                 undegrade_probe_successes: int = 3) -> None:
        assert wb_queue_frames >= 1
        self.geo = geometry
        self.n_engines = n_engines
        self.store = HostPageStore()
        self.frames = HostFrameTable(geometry.frame_pages,
                                     capacity_frames=capacity_frames,
                                     victim_scoring=victim_scoring)
        self.capacity_frames = capacity_frames
        self.spill_enabled = spill and capacity_frames is not None
        self.wb_queue_frames = wb_queue_frames
        self.disk_read_us_per_page = disk_read_us_per_page
        self.disk_write_us_per_page = disk_write_us_per_page
        self.disk_seek_us = disk_seek_us
        self.injector = injector
        self.disk_retries = disk_retries
        self.retry_backoff_us = retry_backoff_us
        self.disk_error_rate_threshold = disk_error_rate_threshold
        self.degraded = False
        # Un-degrade re-probing (ROADMAP fault-tolerance follow-on): a
        # degraded tier probes the disk every interval with a tiny
        # write/read/delete round-trip; after ``undegrade_probe_successes``
        # consecutive clean probes it re-enables the spill path.  None
        # disables probing (degrade stays terminal, the original
        # behavior).  Probes never feed the _note_disk error-rate window.
        self.undegrade_probe_interval_us = undegrade_probe_interval_us
        self.undegrade_probe_successes = undegrade_probe_successes
        self._last_probe_us = 0.0
        self._probe_streak = 0
        self.lost_seqs: Set[int] = set()
        self._disk_ops = 0
        self._disk_errors = 0
        # Reentrancy guard for quarantine: evicting a quarantined owner
        # through its index can touch keys in *other* spilled frames;
        # those are dropped wholesale afterwards instead of recursing.
        self._quarantine_depth = 0
        self._quarantine_queue: List[int] = []
        self.spill_store = SpillStore(spill_dir, injector=injector) \
            if self.spill_enabled else None
        # The write-back buffer rides its own outbound DMA lane(s) on the
        # host link — same AsyncDMAEngine timeline model the engines use,
        # so spill traffic is µs-accounted like every other transfer.
        self.wb_dma = AsyncDMAEngine(link or LinkModel(),
                                     n_channels=max(1, wb_lanes),
                                     injector=injector) \
            if self.spill_enabled else None
        self._pending_wb: Dict[int, float] = {}   # frame → disk-ready µs
        self._spilled: Dict[Key, int] = {}        # key → on-disk frame
        self._now_us = 0.0
        self.stats = {
            "spilled_frames": 0, "spilled_pages": 0,
            "promoted_frames": 0, "promoted_pages": 0,
            "promote_us": 0.0, "spill_write_us": 0.0,
            "spill_cancels": 0, "wb_peak_depth": 0,
            "hard_evicted_pages": 0,
            "disk_errors": 0, "disk_retries": 0, "retry_backoff_us": 0.0,
            "frames_quarantined": 0, "quarantined_pages": 0,
            "quarantine_collateral_frames": 0,
            "lost_seq_count": 0, "reclaimed_frames": 0, "degraded": 0,
            "degrades": 0, "undegrades": 0,
            "probes": 0, "probe_failures": 0,
        }
        self.share_prefix = share_prefix
        if share_prefix:
            self.prefix: Optional[PrefixIndex] = PrefixIndex(
                self.view(PREFIX_DOMAIN), geometry.page_tokens,
                capacity_pages=prefix_capacity_pages)
            self._engine_prefix: List[Optional[PrefixIndex]] = []
        else:
            self.prefix = None
            # Disjoint owner progressions: engine i mints
            # -(i+1), -(i+1+n), -(i+1+2n), … so per-engine payload keys
            # in the one shared store can never collide.
            self._engine_prefix = [
                PrefixIndex(self.view((PREFIX_DOMAIN, i)),
                            geometry.page_tokens,
                            capacity_pages=prefix_capacity_pages,
                            owner_start=-(i + 1), owner_step=-n_engines)
                for i in range(n_engines)]

    def view(self, domain: Domain) -> LeasedStoreView:
        return LeasedStoreView(self.store, self.frames, domain,
                               tier=self if self.capacity_frames is not None
                               else None)

    def prefix_for(self, engine_id: int) -> Optional[PrefixIndex]:
        if self.share_prefix:
            return self.prefix
        return self._engine_prefix[engine_id]

    # -------------------------------------------------------- tier queries

    def is_spilled(self, key: Key) -> bool:
        return key in self._spilled

    def spilled_keys_of(self, seq: int) -> List[Key]:
        return sorted(k for k in self._spilled if k[0] == seq)

    def seq_pages(self, seq: int) -> List[Key]:
        """A sequence's host pages across *both* lower tiers (DRAM +
        disk) — has/seq_pages must see spilled pages or engines would
        treat them as lost."""
        keys = set(self.store.seq_pages(seq))
        keys.update(k for k in self._spilled if k[0] == seq)
        return sorted(keys)

    def park_allowed(self) -> bool:
        """The §11 back-pressure rule: parks are refused while the
        write-back buffer is saturated (never refused when spill is off
        — the hard cap sheds load by evicting instead)."""
        if not self.spill_enabled:
            return True
        return len(self._pending_wb) < self.wb_queue_frames

    def take_lost(self, seq: int) -> bool:
        """True exactly once per sequence whose request-owned host pages
        were destroyed by a frame quarantine (§12) — the owning engine
        checks this and restarts the request from its prompt (the
        deterministic decoder makes the replay byte-identical)."""
        if seq in self.lost_seqs:
            self.lost_seqs.discard(seq)
            return True
        return False

    # --------------------------------------------------------- view hooks

    def before_read(self, key: Key) -> None:
        f = self._spilled.get(key)
        if f is not None:
            self._promote_frame(f)
        self.frames.touch(key)

    def before_write(self, key: Key) -> None:
        f = self._spilled.get(key)
        if f is not None:            # overwrite of a spilled page
            self._promote_frame(f)

    def before_remove(self, key: Key) -> None:
        f = self._spilled.get(key)
        if f is not None:
            if self._quarantine_depth:
                # A quarantine eviction is destroying this key anyway:
                # don't promote (this frame may be corrupt too, and its
                # chain-mates are mid-eviction) — defer a wholesale drop
                # of the frame.  The key stays leased until then, so the
                # caller's store.discard is a no-op.
                self._spilled.pop(key, None)
                if f not in self._quarantine_queue:
                    self._quarantine_queue.append(f)
                return
            self._promote_frame(f)
        f = self.frames.frame_of(key)
        if f is not None and f in self._pending_wb \
                and len(self.frames.keys_of(f)) == 1:
            # The removal would empty (and recycle) a queued frame: the
            # write-back is moot — cancel before the id is reused.
            self._cancel_writeback(f)

    def after_put(self, key: Key) -> None:
        self.frames.touch(key)
        f = self.frames.frame_of(key)
        self._enforce_capacity(
            protect=frozenset(() if f is None else (f,)))

    # ------------------------------------------------------ write-back pump

    def pump(self, now_us: float) -> None:
        """Advance the tier clock; persist write-backs whose DMA + disk
        write completed by ``now_us``, then refill the freed queue slots
        if DRAM is still over capacity.  Engines call this every step."""
        if self.capacity_frames is None:
            return
        self._now_us = max(self._now_us, float(now_us))
        if (self.degraded and self.spill_store is not None
                and self.undegrade_probe_interval_us is not None
                and self._now_us - self._last_probe_us
                >= self.undegrade_probe_interval_us):
            self._last_probe_us = self._now_us
            self.stats["probes"] += 1
            if self._probe_disk():
                self._probe_streak += 1
                if self._probe_streak >= self.undegrade_probe_successes:
                    self._undegrade()
            else:
                self._probe_streak = 0
                self.stats["probe_failures"] += 1
        if not self.spill_enabled:
            return
        self.wb_dma.drain(self._now_us)
        for f in sorted(f for f, t in self._pending_wb.items()
                        if t <= self._now_us):
            if f in self._pending_wb:    # a degrade cancels mid-loop
                self._persist(f)
        self._enforce_capacity()

    def flush(self) -> None:
        """Advance past every queued write-back and persist (tests and
        benches settle the spill pipeline deterministically).  Persisting
        may re-enforce the capacity bound and queue the *next* LRU victim
        behind the now-free buffer slot, so drain until quiescent."""
        if not self.spill_enabled:
            return
        while self._pending_wb:
            self.pump(max(max(self._pending_wb.values()),
                          self.wb_dma.busy_until()))

    def _persist(self, f: int) -> None:
        assert self.frames.state_of(f) == FRAME_PENDING_WB, f
        keys = sorted(self.frames.keys_of(f))
        pages = [(k, self.store.peek(*k)) for k in keys]
        owner = self.frames._frame_owner[f]
        ok, _ = self._with_retries(
            lambda: self.spill_store.write_frame(f, owner, pages))
        if not ok:
            # Retries exhausted (or the tier degraded mid-retry): the
            # data never left DRAM — cancel the write-back and keep
            # serving from the store.  Nothing is lost.
            if f in self._pending_wb:
                self._cancel_writeback(f)
            return
        del self._pending_wb[f]
        for k in keys:
            self.store.discard(*k)
            self._spilled[k] = f
        self.frames.mark_spilled(f)
        self.stats["spilled_frames"] += 1
        self.stats["spilled_pages"] += len(keys)

    def _cancel_writeback(self, f: int) -> None:
        self._pending_wb.pop(f, None)
        self.frames.cancel_writeback(f)
        self.stats["spill_cancels"] += 1

    # ------------------------------------------------------ failure model

    def _with_retries(self, fn):
        """Run a spill-store disk op with bounded retry + exponential
        backoff charged to the tier clock (§12).  Returns ``(ok,
        result)``; transient :class:`SpillIOError`\\ s are retried up to
        ``disk_retries`` times, permanent errors (and exhaustion) yield
        ``ok=False``.  :class:`SpillCorruptionError` is *not* retried —
        re-reading corrupt bytes cannot help — and propagates to the
        caller's quarantine path."""
        delay = self.retry_backoff_us
        for attempt in range(self.disk_retries + 1):
            try:
                out = fn()
                self._note_disk(error=False)
                return True, out
            except SpillIOError as e:
                self._note_disk(error=True)
                if not e.transient or attempt >= self.disk_retries \
                        or self.degraded:
                    return False, None
                self._now_us += delay
                self.stats["disk_retries"] += 1
                self.stats["retry_backoff_us"] += delay
                delay *= 2.0
        return False, None

    def _note_disk(self, *, error: bool) -> None:
        self._disk_ops += 1
        if error:
            self._disk_errors += 1
            self.stats["disk_errors"] += 1
        if (self.spill_enabled and not self.degraded
                and self._disk_ops >= 4
                and self._disk_errors / self._disk_ops
                >= self.disk_error_rate_threshold):
            self._degrade()

    def _degrade(self) -> None:
        """The graceful-degradation rule (§12): the disk is unhealthy,
        so stop trusting it for *new* data — cancel every queued
        write-back (payloads never left DRAM) and drop to the hard-cap
        path.  Frames already spilled stay promotable on touch, parks
        are no longer refused (the hard cap sheds prefix frames through
        the index instead), and no request is dropped."""
        if self.degraded:
            return
        self.degraded = True
        self.spill_enabled = False
        self.stats["degraded"] = 1
        self.stats["degrades"] += 1
        self._probe_streak = 0
        self._last_probe_us = self._now_us
        for f in list(self._pending_wb):
            self._cancel_writeback(f)

    # Probes use a reserved frame id no real lease can hold (HostFrameTable
    # ids count up from 0), so injector budgets and the spill directory
    # never collide with live frames.
    _PROBE_FRAME = -1
    _PROBE_DOMAIN = "__probe__"

    def _probe_disk(self) -> bool:
        """One health probe against the degraded disk: write a tiny
        frame, read it back checksum-verified, delete it.  Failures are
        counted per probe, never fed into the ``_note_disk`` error-rate
        window (a probe must not re-trigger the degrade it is trying to
        lift)."""
        z = torch.zeros((1,), dtype=torch.float32)
        try:
            self.spill_store.write_frame(
                self._PROBE_FRAME, self._PROBE_DOMAIN,
                [((-1, -1, -1), (z, z))])
        except (SpillIOError, SpillCorruptionError):
            return False
        try:
            self.spill_store.read_frame(self._PROBE_FRAME,
                                        expect_domain=self._PROBE_DOMAIN)
            return True
        except (SpillIOError, SpillCorruptionError):
            return False
        finally:
            self.spill_store.delete_frame(self._PROBE_FRAME)

    def _undegrade(self) -> None:
        """Exit hard-cap mode (ROADMAP fault-tolerance follow-on): the
        disk answered ``undegrade_probe_successes`` consecutive probes,
        so new write-backs may trust it again.  The error-rate window
        restarts from zero — a still-flaky disk will re-degrade on its
        own evidence, not on stale counts."""
        if not self.degraded:
            return
        self.degraded = False
        self.spill_enabled = self.spill_store is not None
        self._disk_ops = 0
        self._disk_errors = 0
        self._probe_streak = 0
        self.stats["degraded"] = 0
        self.stats["undegrades"] += 1

    # --------------------------------------------------------- spill policy

    def _enforce_capacity(self, protect: frozenset = frozenset()) -> None:
        if self.capacity_frames is None:
            return
        if not self.spill_enabled:
            self._hard_evict(protect)
            return
        busy = set(protect) | set(self._pending_wb)
        # Queued frames are DRAM-resident but already leaving; count the
        # still-staying frames against the bound, and stop at the
        # write-back buffer's edge — that saturation is exactly what
        # park_allowed() reports upward as back-pressure.
        while (self.frames.resident_frames() - len(self._pending_wb)
               > self.capacity_frames
               and len(self._pending_wb) < self.wb_queue_frames):
            f = self.frames.spill_victim(exclude=busy)
            if f is None:
                break
            self._enqueue_spill(f)
            busy.add(f)

    def _enqueue_spill(self, f: int) -> None:
        """HOST → PENDING_WB: one whole-frame gather on the outbound
        lane (contiguous staging slots ⇒ a single DMA descriptor), then
        the modeled disk write; :meth:`pump` persists at the ready µs."""
        keys = sorted(self.frames.keys_of(f))
        payloads = [self.store.peek(*k) for k in keys]
        page_bytes = int(payloads[0][0].nbytes + payloads[0][1].nbytes)
        job = self.wb_dma.enqueue(keys, list(range(len(keys))), page_bytes,
                                  payloads, self._now_us, kind="spill",
                                  direction="out")
        self.frames.mark_pending_writeback(f)
        self._pending_wb[f] = job.done_us + self.disk_seek_us \
            + len(keys) * self.disk_write_us_per_page
        self.stats["spill_write_us"] += job.transfer_us \
            + self.disk_seek_us + len(keys) * self.disk_write_us_per_page
        self.stats["wb_peak_depth"] = max(self.stats["wb_peak_depth"],
                                          len(self._pending_wb))

    def ensure_resident(self, keys, now_us: Optional[float] = None
                        ) -> float:
        """Promote every spilled frame holding one of ``keys``; returns
        the modeled stall µs (seek + per-page read, per frame) — the
        engine charges it to its clock and to the admission latency."""
        if now_us is not None:
            self._now_us = max(self._now_us, float(now_us))
        stall = 0.0
        for key in keys:
            f = self._spilled.get(tuple(key))
            if f is not None:
                stall += self._promote_frame(f)
        return stall

    def _promote_frame(self, f: int) -> float:
        """SPILLED → HOST: whole-frame disk read back into the store.

        An unreadable frame (permanent error, retries exhausted) or a
        checksum mismatch quarantines instead of promoting — corrupted
        payloads are never put back in the store, so they can never be
        decoded from."""
        try:
            ok, pages = self._with_retries(
                lambda: self.spill_store.read_frame(
                    f, expect_domain=self.frames._frame_owner[f]))
        except SpillCorruptionError:
            ok, pages = False, None
        if not ok:
            return self._quarantine_frame(f)
        cost = self.disk_seek_us + len(pages) * self.disk_read_us_per_page
        for key, (kp, vp) in pages:
            self._spilled.pop(key, None)
            self.store.put(key[0], key[1], key[2], kp, vp, kind="promote")
        self.frames.promote(f)
        self.spill_store.delete_frame(f)
        self.stats["promoted_frames"] += 1
        self.stats["promoted_pages"] += len(pages)
        self.stats["promote_us"] += cost
        self._now_us += cost
        # The promote may itself overflow DRAM: spill someone colder
        # (never the frame just promoted — it is the hottest by touch).
        self._enforce_capacity(protect=frozenset((f,)))
        return cost

    def _quarantine_frame(self, f: int) -> float:
        """A spill frame is unreadable or corrupt (§12): destroy it and
        rebuild its contents from upstream truth.  The frame's keys
        leave both lower tiers; prefix payloads are evicted through
        their index so future matches re-derive (suffix re-prefill on
        the next admission), and request sequences are marked *lost* so
        the owning engine restarts them from the prompt.

        Evicting an owner can cascade through its chain descendants
        into *other* spilled frames; :meth:`before_remove` defers those
        to ``_quarantine_queue`` (promoting mid-eviction would recurse
        into this method and double-evict chain pages), and they are
        dropped wholesale here once the triggering eviction unwinds.
        Returns the modeled stall (the seek that discovered the failure
        — backoff for any retries was already charged)."""
        self._quarantine_depth += 1
        try:
            self._drop_quarantined(f, corrupt=True)
            while self._quarantine_queue:
                self._drop_quarantined(self._quarantine_queue.pop(),
                                       corrupt=False)
        finally:
            self._quarantine_depth -= 1
        return self.disk_seek_us

    def _drop_quarantined(self, f: int, *, corrupt: bool) -> None:
        """Destroy one spilled frame and re-sync every owner it held:
        ``corrupt=False`` marks a collateral drop — a healthy frame
        whose pages were chained to a quarantined owner."""
        keys = sorted(self.frames.keys_of(f))
        if corrupt:
            self.spill_store.quarantine_frame(f)
            self.stats["frames_quarantined"] += 1
        else:
            self.spill_store.delete_frame(f)
            self.stats["quarantine_collateral_frames"] += 1
        self.frames.promote(f)          # table-only: SPILLED → HOST
        for k in keys:
            self._spilled.pop(k, None)
            self.frames.release(k)
        for owner in sorted({k[0] for k in keys}):
            idx = self._index_for_owner(owner)
            if idx is not None:
                # Losing any page breaks the chain: evict the whole
                # owner through the index so index↔store stay in sync
                # and descendants never match a hole (no-op for owners
                # the triggering eviction already removed).
                idx.evict_owner_pages({owner})
            elif owner >= 0:
                self.lost_seqs.add(owner)
                self.stats["lost_seq_count"] += 1
        self.stats["quarantined_pages"] += len(keys)

    def _hard_evict(self, protect: frozenset = frozenset()) -> None:
        """The no-spill baseline: shed over-capacity *prefix* frames by
        evicting their owners through the index (request frames hold
        unreconstructible payloads and are never dropped)."""
        while self.frames.resident_frames() > self.capacity_frames:
            f = self.frames.spill_victim(exclude=protect,
                                         owner_ok=self._is_prefix_domain)
            if f is None:
                break
            evicted = 0
            for owner in sorted({k[0] for k in self.frames.keys_of(f)}):
                idx = self._index_for_owner(owner)
                if idx is not None:
                    evicted += idx.evict_owner_pages({owner})
            if evicted == 0:
                break               # nothing reachable through an index
            self.stats["hard_evicted_pages"] += evicted

    @staticmethod
    def _is_prefix_domain(domain: Domain) -> bool:
        return domain == PREFIX_DOMAIN or (
            isinstance(domain, tuple) and bool(domain)
            and domain[0] == PREFIX_DOMAIN)

    def _index_for_owner(self, owner: int) -> Optional[PrefixIndex]:
        """The index that minted a negative payload owner id (per-engine
        indexes use the progression owner = -(i+1) - k·n, DESIGN.md §10)."""
        if owner >= 0:
            return None
        if self.share_prefix:
            return self.prefix
        return self._engine_prefix[(-owner - 1) % self.n_engines]

    # ------------------------------------------------------------ migrate

    def migrate_seq(self, seq: int, dst_engine: int) -> int:
        """Re-lease a request's host pages to another engine's domain —
        the data half of work-stealing migration.  Spilled frames are
        promoted first and queued write-backs cancelled: the on-disk
        file records a single domain, and a migrating frame's domain is
        about to change."""
        keys = self.seq_pages(seq)
        self.ensure_resident([k for k in keys if k in self._spilled])
        for k in keys:
            f = self.frames.frame_of(k)
            if f is not None and f in self._pending_wb:
                self._cancel_writeback(f)
        return self.frames.migrate(keys, dst_engine)

    # ------------------------------------------------------- crash reclaim

    def reclaim_domain(self, domain: Domain) -> int:
        """Reclaim every frame leased to ``domain`` whole (engine death,
        §12).  The router calls this *after* the victim's preempted
        bundles have migrated to survivors — whatever still belongs to
        the dead engine's domain is unreachable state, recycled at
        frame granularity exactly like a normal whole-frame return.
        Prefix-domain frames are a different domain by construction and
        survive untouched (parked KV outlives its parker).  Returns the
        number of frames reclaimed."""
        victims = sorted(f for f, d in self.frames._frame_owner.items()
                         if d == domain)
        for f in victims:
            if f in self._pending_wb:
                self._cancel_writeback(f)
            keys = sorted(self.frames.keys_of(f))
            if self.frames.state_of(f) == FRAME_SPILLED:
                # Discard the on-disk frame wholesale — no need to read
                # payloads that are about to be dropped.
                self.frames.promote(f)      # table-only state flip
                for k in keys:
                    self._spilled.pop(k, None)
                    self.frames.release(k)
                self.spill_store.delete_frame(f)
            else:
                for k in keys:
                    self.store.discard(*k)
                    self.frames.release(k)
        self.stats["reclaimed_frames"] += len(victims)
        return len(victims)

    def check_invariants(self) -> None:
        self.frames.check_invariants()
        # Every stored payload is placed, in a DRAM-resident frame.
        for key in self.store._pages:
            f = self.frames.frame_of(key)
            assert f is not None, f"host page {key} stored but not leased"
            assert self.frames.state_of(f) != FRAME_SPILLED, \
                f"stored page {key} in spilled frame {f}"
        # Placed keys partition across the two lower tiers by state.
        for f, keys in self.frames._frame_keys.items():
            spilled = self.frames.state_of(f) == FRAME_SPILLED
            for k in keys:
                if spilled:
                    assert k in self._spilled and k not in self.store._pages
                else:
                    assert k in self.store._pages, \
                        f"page {k} leased in DRAM frame {f} but not stored"
        for key, f in self._spilled.items():
            assert self.frames.state_of(f) == FRAME_SPILLED, (key, f)
            assert self.spill_store.has_frame(f)
        for f in self._pending_wb:
            assert self.frames.state_of(f) == FRAME_PENDING_WB, f
        if self.spill_store is not None:
            # Guard on the store, not spill_enabled: a degraded tier
            # (§12) still owns promotable on-disk frames.
            for f in self.spill_store.frame_ids():
                assert self.frames.state_of(f) == FRAME_SPILLED, f


# ---------------------------------------------------------------- cluster


def aggregate_engine_stats(stats: Sequence[EngineStats]) -> EngineStats:
    """Sum scalar counters (and merge the per-tier deadline dicts) of
    several replicas into one cluster-wide :class:`EngineStats` — the
    result supports the same ``summary()`` / ``slo_attainment()`` API."""
    agg = EngineStats()
    for st in stats:
        for f in dataclasses.fields(EngineStats):
            v = getattr(st, f.name)
            if isinstance(v, list):
                # Per-admission samples (admit_lat_us): concatenate so
                # cluster-wide percentiles see every engine's tail.
                getattr(agg, f.name).extend(v)
            elif isinstance(v, (int, float)):
                setattr(agg, f.name, getattr(agg, f.name) + v)
        for tier, n in st.deadline_hits.items():
            agg.deadline_hits[tier] = agg.deadline_hits.get(tier, 0) + n
        for tier, n in st.deadline_misses.items():
            agg.deadline_misses[tier] = agg.deadline_misses.get(tier, 0) + n
    return agg


class ClusterStats:
    """Cluster-wide rollup: per-engine EngineStats aggregated, router
    dispatch/migration counters, and host-tier frame-lease stats."""

    def __init__(self, engines: Sequence[ServingEngine],
                 router: RequestRouter,
                 tier: Optional[SharedHostTier]) -> None:
        self.engines = list(engines)
        self.router = router
        self.tier = tier

    @property
    def totals(self) -> EngineStats:
        return aggregate_engine_stats([e.stats for e in self.engines])

    def slo_attainment(self, priority: Optional[int] = None
                       ) -> Optional[float]:
        return self.totals.slo_attainment(priority)

    def prefix_hit_rate(self) -> float:
        t = self.totals
        return t.prefix_hits / max(t.prefix_hits + t.prefix_misses, 1)

    def summary(self) -> str:
        lines = [f"cluster: {len(self.engines)} engines | "
                 f"{self.totals.summary()}"]
        for e in self.engines:
            lines.append(f"  engine[{e.engine_id}]: {e.stats.summary()}")
        r = self.router.stats
        lines.append(
            f"  router: {r.submitted} submitted | dispatched "
            + (", ".join(f"e{i}:{n}" for i, n in sorted(r.dispatched.items()))
               or "-")
            + f" | migrations {r.migrations} ({r.migrated_pages} pages)")
        if r.queued_steals or r.prestaged_requests:
            lines.append(
                f"  router §14: {r.queued_steals} queued steals | "
                f"{r.prestaged_requests} pre-staged, "
                f"{r.prestage_cancels} cancelled "
                f"({r.prestage_refund_us:.0f}us refunded)")
        if self.tier is not None:
            fs = self.tier.frames.stats
            lines.append(
                f"  host tier: {len(self.tier.store)} pages in "
                f"{len(self.tier.frames)} frames (peak {fs['peak_frames']}) "
                f"| moves {fs['whole_frame_moves']} whole-frame / "
                f"{fs['page_moves']} page")
            ts = self.tier.stats
            if ts["spilled_frames"] or ts["promoted_frames"] \
                    or ts["hard_evicted_pages"]:
                lines.append(
                    f"  spill: {ts['spilled_frames']} frames out "
                    f"({ts['spilled_pages']} pages) / "
                    f"{ts['promoted_frames']} promoted back "
                    f"({ts['promote_us']:.0f}us stall) | cancels "
                    f"{ts['spill_cancels']} | hard-evicted "
                    f"{ts['hard_evicted_pages']} pages")
        return "\n".join(lines)


class ServingCluster:
    """N :class:`ServingEngine` replicas + shared host tier + router.

    All replicas share one ``params`` pytree (replica equivalence is what
    makes cross-engine prefix reuse and migration bitwise-safe), their
    own pools/DMA lanes/clocks, and — unless ``share_host=False`` (the
    per-engine baseline the benches compare against) — one
    :class:`SharedHostTier`.
    """

    def __init__(self, cfg: ModelConfig, *, geometry: PoolGeometry,
                 n_engines: int = 2, max_batch: int = 4, max_seq: int = 128,
                 manager_kind: str = "mosaic", seed: int = 0,
                 share_host: bool = True, share_prefix: bool = True,
                 prefix_cache: bool = True,
                 prefix_capacity_pages: int = 4096,
                 router_policy: str = "slack", migrate: bool = True,
                 router_cost_model: str = "modeled",
                 router_prestage: bool = False,
                 router_steal_queued: bool = True,
                 router_translation_aware: bool = True,
                 capacity_frames: Optional[int] = None,
                 spill: bool = True, spill_dir: Optional[str] = None,
                 wb_queue_frames: int = 4, wb_lanes: int = 1,
                 disk_read_us_per_page: float = 25.0,
                 disk_write_us_per_page: float = 25.0,
                 disk_seek_us: float = 100.0,
                 fault_injector: Optional[FaultInjector] = None,
                 disk_retries: int = 3,
                 retry_backoff_us: float = 50.0,
                 disk_error_rate_threshold: float = 0.5,
                 victim_scoring: str = "lru",
                 undegrade_probe_interval_us: Optional[float] = 10_000.0,
                 undegrade_probe_successes: int = 3,
                 **engine_kw) -> None:
        assert n_engines >= 1
        self.cfg = cfg
        self.geo = geometry
        self.fault_injector = fault_injector
        self.tier: Optional[SharedHostTier] = None
        if share_host:
            self.tier = SharedHostTier(
                geometry, n_engines=n_engines, share_prefix=share_prefix,
                prefix_capacity_pages=prefix_capacity_pages,
                capacity_frames=capacity_frames, spill=spill,
                spill_dir=spill_dir, wb_queue_frames=wb_queue_frames,
                wb_lanes=wb_lanes,
                disk_read_us_per_page=disk_read_us_per_page,
                disk_write_us_per_page=disk_write_us_per_page,
                disk_seek_us=disk_seek_us,
                injector=fault_injector, disk_retries=disk_retries,
                retry_backoff_us=retry_backoff_us,
                disk_error_rate_threshold=disk_error_rate_threshold,
                victim_scoring=victim_scoring,
                undegrade_probe_interval_us=undegrade_probe_interval_us,
                undegrade_probe_successes=undegrade_probe_successes)
        self.engines: List[ServingEngine] = []
        params = None
        for i in range(n_engines):
            eng = ServingEngine(
                cfg, geometry=geometry, max_batch=max_batch,
                max_seq=max_seq, manager_kind=manager_kind, seed=seed,
                params=params, engine_id=i,
                host=self.tier.view(i) if self.tier else None,
                prefix_index=(self.tier.prefix_for(i)
                              if self.tier and prefix_cache else None),
                prefix_cache=prefix_cache,
                prefix_capacity_pages=prefix_capacity_pages,
                injector=fault_injector,
                **engine_kw)
            params = eng.params          # replicas share one weight tree
            self.engines.append(eng)
        self.router = RequestRouter(self.engines, tier=self.tier,
                                    policy=router_policy, migrate=migrate,
                                    injector=fault_injector,
                                    cost_model=router_cost_model,
                                    prestage=router_prestage,
                                    steal_queued=router_steal_queued,
                                    translation_aware=(
                                        router_translation_aware))

    # ------------------------------------------------------------- serving

    def submit(self, req: Request, engine: Optional[int] = None) -> None:
        self.router.submit(req, engine=engine)

    def step(self) -> bool:
        return self.router.step()

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        return self.router.run_until_drained(max_steps=max_steps)

    # ------------------------------------------------------------- stats

    def stats(self) -> ClusterStats:
        return ClusterStats(self.engines, self.router, self.tier)

    def check_invariants(self) -> None:
        for e in self.engines:
            if e.alive:                 # a crashed engine's device state
                e.cache.check_invariants()   # is gone by definition
        if self.tier is not None:
            self.tier.check_invariants()
