"""Async double-buffered fault-in: hide host→device DMA behind decode.

PR 1's demand paging is synchronous: the whole batch stalls on the full
gather-transfer before decode runs, so every host-tier fault is exposed
latency.  Mosaic's en-masse, contiguity-preserving allocation makes page
touches *predictable* — the pages step N+1 will read are knowable at step
N — so (GPUVM-style) the transfer can run on a DMA channel *while* step N
decodes, and only the remainder is exposed.

Three cooperating pieces (DESIGN.md §7):

* :class:`AsyncDMAEngine` — models ``n_channels`` DMA channels on the
  host↔device link with an explicit microsecond timeline.  An enqueued
  job gets a start timestamp (``max(now, channel_free)``) and a
  completion timestamp (``start + transfer_us`` from the shared
  :class:`~repro.core.demand_paging.LinkModel` / contiguous-run cost
  model).  Per-job transfer time is split into *hidden* µs (overlapped
  with compute: the job completed before anyone waited on it, or the
  waited-on portion that had already elapsed) and *exposed* µs (the
  portion the engine stalled on); ``hidden + exposed == transfer_us``
  for every job, and channel-queueing delay beyond the transfer itself
  is tracked separately as ``queue_us``.  The link is *full-duplex*
  (DESIGN.md §8): outbound device→host traffic — preemption eviction
  gathers and cold-prefix parking — rides the same channels on
  independent per-direction timelines, accounted under the ``*_out``
  stat keys with the same per-direction hidden/exposed/queue split.
* :class:`StagingBuffer` — the double-buffered staging region completed
  prefetches scatter into.  Ownership rule: the DMA engine's completions
  land only in the *back* buffer; the engine's fault-in path reads only
  the *front* buffer; :meth:`StagingBuffer.swap` (called once at step
  start, before admission) publishes back→front.  Unconsumed front
  entries are retained across swaps — the host copy stays authoritative
  until a payload is actually scattered into a mapped pool page, so a
  retained (or even dropped) staged page is never a correctness hazard,
  only accounted waste.
* :class:`Prefetcher` — predicts step N+1's page touches at step N: the
  host-backed pages among each active request's mapped set (its next
  token-slot page included) plus the pages of the next preempted
  requests eligible for resume, in the same priority-then-FIFO order
  the engine's admission loop uses.  Predicted pages are issued to the
  DMA engine right before the decode call and drain into staging while
  decode runs.

Payloads are staged as *copies* keyed by logical identity
``(seq, shard, vpn)`` (same keying as the
:class:`~repro.serving.host_tier.HostPageStore`), so compaction moving a
page's physical location never invalidates a staged entry, and a wrong
prediction loses nothing: the host copy is only popped at consumption.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.demand_paging import FaultBatch, LinkModel

Key = Tuple[int, int, int]          # (seq, shard, local vpn)


@dataclasses.dataclass
class DMAJob:
    """One enqueued gather-transfer on a DMA channel.

    ``ppns`` feed the contiguous-run cost model: real physical pages for
    demand faults (device-side scatter targets), synthetic contiguous
    staging slots for resume prefetches (the staging region is a
    contiguous device buffer, so a host→staging gather always merges).

    ``direction`` is the link direction the job occupies: ``"in"``
    (host→device: demand faults, prefetches) or ``"out"`` (device→host:
    preemption eviction gathers, cold-prefix parking, and the host
    tier's whole-frame ``"spill"`` write-backs toward disk — DESIGN.md
    §11).  On a full-duplex link the two directions have independent
    per-channel timelines.
    """

    job_id: int
    keys: List[Key]
    batch: FaultBatch
    start_us: float
    done_us: float
    payloads: List[Tuple[np.ndarray, np.ndarray]]
    kind: str = "prefetch"   # "prefetch" | "demand" | "evict" | "park" | "spill"
    direction: str = "in"           # "in" (h→d) | "out" (d→h)
    channel: int = -1
    settled: bool = False           # hidden/exposed already accounted

    @property
    def transfer_us(self) -> float:
        return self.batch.transfer_us

    @property
    def dma_count(self) -> int:
        return self.batch.dma_count

    @property
    def nbytes(self) -> int:
        return self.batch.nbytes

    def page_done_us(self, i: int) -> float:
        """Modeled completion timestamp of this job's ``i``-th page.

        Pages land in key order along the merged transfer, so page ``i``
        becomes readable at ``start + transfer · (i+1)/n`` — the
        per-page readiness timeline the fused decode path consumes:
        pages whose timestamp falls inside the decode window are drained
        in-kernel for free, only the tail past ``done_us`` is exposed
        (DESIGN.md §13).
        """
        n = max(len(self.keys), 1)
        return self.start_us + self.transfer_us * (i + 1) / n


class AsyncDMAEngine:
    """N-channel host⇄device DMA timeline with hidden/exposed accounting.

    The clock is *modeled* microseconds supplied by the caller (the
    engine advances it by measured decode wall time and by exposed
    stalls), so the engine, the benches and the tests all reason on one
    explicit timeline.

    The link is **full-duplex** by default (real PCIe is): each channel
    carries one inbound (host→device) and one outbound (device→host)
    transfer concurrently, so eviction gathers riding the "out" lanes
    never delay fault-ins riding the "in" lanes — they only queue behind
    other outbound traffic.  ``duplex=False`` degrades to a half-duplex
    link where both directions contend for the same channel timeline
    (the PR 2 single-timeline model, kept for comparison benches).

    Stats are kept per direction: the un-suffixed keys (``transfer_us``,
    ``hidden_us``, ``exposed_us``, ``queue_us``, ``pages``, ``bytes``,
    ``dma_count``) are the **inbound** totals — exactly what they meant
    before outbound modeling existed — and the ``*_out`` keys account the
    outbound lanes.  The per-direction invariant ``hidden + exposed ==
    Σ transfer_us`` holds over settled jobs in each direction.
    """

    def __init__(self, link: Optional[LinkModel] = None,
                 n_channels: int = 2, duplex: bool = True,
                 injector=None):
        assert n_channels >= 1
        self.link = link or LinkModel()
        self.duplex = duplex
        # Failure model (DESIGN.md §12): an injector may stall a lane —
        # the job (and its channel) finishes late by the injected µs.
        self.injector = injector
        free_in = [0.0] * n_channels
        # Half-duplex shares the *same list object*, so either direction's
        # enqueue occupies the single per-channel timeline.
        free_out = [0.0] * n_channels if duplex else free_in
        self.channel_free = {"in": free_in, "out": free_out}
        self._ids = itertools.count()
        self.in_flight: Dict[int, DMAJob] = {}
        self.stats = {
            "jobs": 0, "prefetch_jobs": 0, "demand_jobs": 0,
            "evict_jobs": 0, "park_jobs": 0, "spill_jobs": 0,
            "pages": 0, "dma_count": 0, "bytes": 0,
            "transfer_us": 0.0,     # Σ per-job transfer_us (hidden+exposed)
            "hidden_us": 0.0,       # overlapped with compute
            "exposed_us": 0.0,      # stalled-on portion of transfers
            "queue_us": 0.0,        # stalled waiting for a busy channel
            "pages_out": 0, "dma_count_out": 0, "bytes_out": 0,
            "transfer_us_out": 0.0, "hidden_us_out": 0.0,
            "exposed_us_out": 0.0, "queue_us_out": 0.0,
            "injected_stall_us": 0.0,
            "cancelled_jobs": 0,
            "refunded_us": 0.0, "refunded_us_out": 0.0,
        }

    @staticmethod
    def _sfx(direction: str) -> str:
        return "" if direction == "in" else "_out"

    # ------------------------------------------------------------- enqueue

    def enqueue(self, keys: Sequence[Key], ppns: Sequence[int],
                page_bytes: int,
                payloads: Sequence[Tuple[np.ndarray, np.ndarray]],
                now_us: float, kind: str = "prefetch",
                direction: str = "in") -> DMAJob:
        """Queue one gather-transfer; returns the job with its timeline."""
        assert len(keys) == len(ppns) == len(payloads)
        assert direction in ("in", "out"), direction
        batch = FaultBatch([int(p) for p in ppns], page_bytes, self.link)
        free = self.channel_free[direction]
        ch = min(range(len(free)), key=lambda c: free[c])
        start = max(float(now_us), free[ch])
        done = start + batch.transfer_us
        if self.injector is not None:
            # An injected lane stall delays this job's completion and
            # occupies the channel for the extra µs (a throttled lane
            # backs up everything queued behind it).
            extra = self.injector.dma_stall(kind, direction)
            if extra:
                done += extra
                self.stats["injected_stall_us"] += extra
        free[ch] = done
        job = DMAJob(job_id=next(self._ids), keys=list(keys), batch=batch,
                     start_us=start, done_us=done, payloads=list(payloads),
                     kind=kind, direction=direction, channel=ch)
        self.in_flight[job.job_id] = job
        sfx = self._sfx(direction)
        self.stats["jobs"] += 1
        self.stats[f"{kind}_jobs"] += 1
        self.stats[f"pages{sfx}"] += len(job.keys)
        self.stats[f"dma_count{sfx}"] += job.dma_count
        self.stats[f"bytes{sfx}"] += job.nbytes
        self.stats[f"transfer_us{sfx}"] += job.transfer_us
        return job

    # ------------------------------------------------------------- settle

    def wait(self, job: DMAJob, now_us: float) -> float:
        """Stall until ``job`` completes; returns the advanced clock.

        The stall splits into the *exposed* part of the transfer itself
        (at most ``transfer_us``) and channel-*queueing* delay (the job
        had not even started because the channel was busy); the
        remainder of the transfer was *hidden* behind compute that
        already ran.
        """
        stall = max(0.0, job.done_us - now_us)
        if not job.settled:
            sfx = self._sfx(job.direction)
            exposed = min(stall, job.transfer_us)
            self.stats[f"exposed_us{sfx}"] += exposed
            self.stats[f"hidden_us{sfx}"] += job.transfer_us - exposed
            self.stats[f"queue_us{sfx}"] += stall - exposed
            job.settled = True
        self.in_flight.pop(job.job_id, None)
        return max(float(now_us), job.done_us)

    def drain(self, now_us: float) -> List[DMAJob]:
        """Harvest jobs whose completion timestamp has passed.

        A drained job completed strictly in the background, so its whole
        transfer was hidden behind compute.
        """
        done = [j for j in self.in_flight.values()
                if j.done_us <= float(now_us)]
        for j in done:
            if not j.settled:
                self.stats[f"hidden_us{self._sfx(j.direction)}"] \
                    += j.transfer_us
                j.settled = True
            del self.in_flight[j.job_id]
        return sorted(done, key=lambda j: (j.done_us, j.job_id))

    def cancel(self, job: DMAJob, now_us: float) -> float:
        """Cancel an in-flight job and refund the un-elapsed lane time.

        Used by pre-staging when a steal or a crash retargets a queued
        request (DESIGN.md §14).  The elapsed portion of the transfer
        already moved bytes; it settles as *hidden* µs (wasted, but the
        lane time was genuinely spent overlapped with other work).  The
        un-elapsed remainder is refunded: if the job is still the last
        booking on its channel the lane's busy horizon rolls back to the
        cancellation point, and the refunded µs leave ``transfer_us`` so
        the per-direction ``hidden + exposed == Σ transfer_us`` invariant
        holds over settled jobs.  A job that later transfers already
        queued behind cannot be un-booked — the lane stays busy either
        way — so its whole transfer settles as hidden with zero refund.
        Returns the refunded µs.
        """
        if job.settled or job.job_id not in self.in_flight:
            return 0.0
        sfx = self._sfx(job.direction)
        now = float(now_us)
        elapsed = min(max(0.0, now - job.start_us), job.transfer_us)
        free = self.channel_free[job.direction]
        refund = 0.0
        if free[job.channel] == job.done_us:
            refund = job.transfer_us - elapsed
            # Roll the lane back to start+elapsed (this also drops any
            # injected stall tail — a cancelled job no longer occupies
            # its throttled lane past the cancellation point).
            free[job.channel] = max(job.start_us, min(now, job.done_us))
        else:
            elapsed = job.transfer_us
        self.stats[f"hidden_us{sfx}"] += elapsed
        self.stats[f"transfer_us{sfx}"] -= refund
        self.stats[f"refunded_us{sfx}"] += refund
        self.stats["cancelled_jobs"] += 1
        job.settled = True
        del self.in_flight[job.job_id]
        return refund

    # ------------------------------------------------------------- queries

    def busy_until(self) -> float:
        return max(max(self.channel_free["in"]),
                   max(self.channel_free["out"]))


class StagingBuffer:
    """Double-buffered staging region for completed prefetch payloads.

    Ownership rules (DESIGN.md §7): DMA completions are staged into the
    *back* buffer only; the engine's fault-in path consumes from the
    *front* buffer only; ``swap()`` runs once per step, before admission,
    publishing back→front.  Unconsumed front entries are retained (the
    payload was already transferred; the host copy stays authoritative
    until consumption), and invalidation simply drops entries — safe
    because staged payloads are copies.

    Every staged key also gets a monotonically increasing ``slot_of``
    id: the stable address of that page inside the staging region.  The
    fused decode path (DESIGN.md §13) re-bases the slots it consumes
    into a dense step-local stage pool addressable by the kernel's page
    table, so attention reads late arrivals straight from staging with
    no second copy.
    """

    def __init__(self) -> None:
        self._front: Dict[Key, Tuple[np.ndarray, np.ndarray]] = {}
        self._back: Dict[Key, Tuple[np.ndarray, np.ndarray]] = {}
        self._slots: Dict[Key, int] = {}
        self._next_slot = 0
        self.stats = {"staged": 0, "consumed": 0, "invalidated": 0,
                      "peak_front": 0}

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def stage(self, key: Key,
              payload: Tuple[np.ndarray, np.ndarray]) -> None:
        self._back[key] = payload
        if key not in self._slots:
            self._slots[key] = self._next_slot
            self._next_slot += 1
        self.stats["staged"] += 1

    def slot_of(self, key: Key) -> Optional[int]:
        """Staging-region slot of a currently staged key (None if absent)."""
        return self._slots.get(key) if self.contains(key) else None

    def swap(self) -> None:
        self._front.update(self._back)
        self._back = {}
        self.stats["peak_front"] = max(self.stats["peak_front"],
                                       len(self._front))

    def has(self, key: Key) -> bool:
        return key in self._front

    def contains(self, key: Key) -> bool:
        """In either buffer (prefetch dedup: staged ⇒ don't re-issue)."""
        return key in self._front or key in self._back

    def consume(self, key: Key
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        payload = self._front.pop(key, None)
        if payload is not None:
            if key not in self._back:
                self._slots.pop(key, None)
            self.stats["consumed"] += 1
        return payload

    def invalidate_seq(self, seq: int) -> int:
        """Drop a sequence's staged pages (request completed/cancelled)."""
        n = 0
        for buf in (self._front, self._back):
            for k in [k for k in buf if k[0] == seq]:
                del buf[k]
                self._slots.pop(k, None)
                n += 1
        self.stats["invalidated"] += n
        return n


class Prefetcher:
    """Predicts step N+1's host-backed page touches and tracks issues.

    ``depth`` bounds how many preemption victims ahead of the resume
    queue are prefetched per step (the engine may resume several in one
    admission round when capacity frees en masse).  Under SLO-aware
    resume scheduling (DESIGN.md §8) the *effective* depth follows the
    deadline pressure of the resume queue: :meth:`plan_depth` widens the
    window to cover every candidate whose deadline slack is inside
    ``urgency_us``, so urgent resumes have their pages staged before the
    admission round that re-admits them.
    """

    def __init__(self, depth: int = 2):
        self.depth = depth
        self.in_flight: Dict[Key, DMAJob] = {}
        self.stats = {"issued_pages": 0, "hits": 0, "misses": 0,
                      "wasted_pages": 0, "planned_depth": depth,
                      "max_planned_depth": depth}

    # ------------------------------------------------------------- depth

    def plan_depth(self, slacks: Sequence[Optional[float]],
                   urgency_us: float) -> int:
        """Deadline-weighted prefetch depth for this step.

        ``slacks`` are the resume candidates' ``deadline − now`` in µs,
        in resume order (``None`` = no deadline).  The planned depth is
        the base ``depth`` widened to cover all candidates with slack ≤
        ``urgency_us`` (deadline already blown counts as maximally
        urgent), capped at the queue length.
        """
        urgent = sum(1 for s in slacks if s is not None and s <= urgency_us)
        eff = max(self.depth, urgent)
        if slacks:
            eff = min(eff, len(slacks))
        self.stats["planned_depth"] = eff
        self.stats["max_planned_depth"] = max(
            self.stats["max_planned_depth"], eff)
        return eff

    # ------------------------------------------------------------- predict

    def predict(self, cache, host, active_seqs: Sequence[int],
                resume_order: Sequence[int], depth: Optional[int] = None
                ) -> List[Tuple[Key, Optional[int]]]:
        """[(key, ppn-or-None)] the next step will touch but is not
        HBM-resident.

        * Active requests: the non-resident subset of their mapped pages
          (the packed tables of step N+1 read all of them; this includes
          the next token-slot page).  These have physical targets, so
          their ``ppn`` rides along for contiguity costing.
        * The next ``depth`` preempted requests in resume order (the
          caller passes :meth:`plan_depth`'s value when scheduling is
          SLO-aware): every host-parked page (no physical target yet —
          the resume will re-map them; transfers land in staging).
        """
        out: List[Tuple[Key, Optional[int]]] = []
        for seq, s, vpn, ppn in cache.host_backed_pages(active_seqs, host):
            out.append(((seq, s, vpn), ppn))
        for rid in list(resume_order)[:self.depth if depth is None else depth]:
            for key in host.seq_pages(rid):
                out.append((key, None))
        return out

    # ------------------------------------------------------------- issue

    def cancel_seq(self, seq: int) -> None:
        for k in [k for k in self.in_flight if k[0] == seq]:
            del self.in_flight[k]

    def forget(self, keys: Iterable[Key]) -> None:
        for k in keys:
            self.in_flight.pop(k, None)
