"""Multi-tenant continuous-batching serving engine on the Mosaic pool.

Counterpart of the reference's ``serving/engine.py`` for one engine:
admission with priority preemption, en-masse prefill, batched paged
decode, host-tier demand paging in three fault modes, and CAC compaction.

Lifecycle per request: admit → prefill (en-masse allocation) → join the
decode batch → complete → deallocate.  The pool may be oversubscribed: each
step ``touch()``es the pages its packed tables will read and faults the
missing ones in from the :class:`HostPageStore` (blocking: the whole
transfer is exposed); an allocation that hits ``OutOfMemory`` even after
CAC compaction preempts the cheapest-to-evict active request, whose
resident pages are gathered to the host store at base-page granularity and
faulted back in after it resumes.  A resumed request produces exactly the
tokens it would have produced unpreempted.

Fault modes (the reference's, same names, same default):

* ``"sync"``: the blocking path above.
* ``"async"`` (the default): each step first drains the prefetches that
  completed during the previous decode into the double-buffered staging
  region (:mod:`repro_torch.serving.dma`), faults only the remaining
  misses (exposed µs), then issues the predicted next-step touches so their
  transfers overlap this step's decode (hidden µs).  Eviction gathers ride
  the link's outbound lanes.  Only the modeled timeline differs from sync:
  every payload still lands through one host→device copy and one scatter.
* ``"fused"``: no pre-decode barrier.  This step's misses resolve to
  staged, in-flight or fresh demand payloads; they are copied to the card
  once as a step-local stage ``[L, NS, ptok, n_kv, dh]`` and decode reads
  them where they landed through the fused gather-attend kernel (a slot
  table beside the page tables), then the same bytes are scattered into
  the pool after decode.  The write page lands before decode.  Tokens are
  identical across the three modes because attention folds pages in the
  same order whatever their source.

On a CUDA device every page movement and every decode attention runs in
the port's hand-written kernels (``repro_torch.kernels``); the eviction
gather's ``.cpu()`` and the fault-in scatter's ``.to(device)`` are the real
PCIe transfers, timed into :class:`EngineStats`.  The modeled counters
(``faults``, ``fault_dmas``, ``bytes_in``, ``transfer_us``) come from the
same link model as the reference's, so both engines report them equal for
the same schedule.

Not in this slice (raise ``NotImplementedError``): the prefix cache, the
translation meter, and the cluster tier's shared host store, prefix index,
failure injection and spill promotion.  The pools and the pool writes of
decode, fault-in and compaction are updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, PoolGeometry
from repro_torch.core.cocoa import OutOfMemory
from repro_torch.core.demand_paging import LinkModel
from repro_torch.kernels import ops as kops
from repro_torch.models.lm import LM
from repro_torch.models.transformer import PageCtx
from repro_torch.serving.dma import (AsyncDMAEngine, DMAJob, Key, Prefetcher,
                                     StagingBuffer)
from repro_torch.serving.host_tier import HostPageStore
from repro_torch.serving.kv_cache import ShardedKVCache


@dataclasses.dataclass
class Request:
    rid: int
    tenant: int
    prompt: np.ndarray           # int32 [T]
    max_new: int
    priority: int = 0            # higher = more important (preempt lowest)
    # SLO deadline on the engine's modeled µs clock: among same-priority
    # candidates, tighter slack is admitted first.  None = best-effort.
    deadline_us: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    compaction_copies: int = 0
    wall_s: float = 0.0
    coalesced_sum: float = 0.0   # running sum of per-step coalesced fraction
    occupancy_sum: float = 0.0
    # Host-tier demand paging, modeled by the link model (as the reference).
    faults: int = 0              # base pages faulted in
    fault_dmas: int = 0          # DMA descriptors (contiguous runs)
    fault_steps: int = 0         # engine steps that faulted at all
    bytes_in: int = 0
    transfer_us: float = 0.0
    swaps_out: int = 0           # whole-request preemptions
    swaps_in: int = 0            # whole-request resumes
    # Async fault-in pipeline, modeled µs.
    fault_exposed_us: float = 0.0   # transfer µs the engine stalled on
    fault_hidden_us: float = 0.0    # transfer µs overlapped with decode
    prefetch_hits: int = 0          # faults served from staging/in-flight
    prefetch_misses: int = 0        # demand faults the prefetcher missed
    prefetch_wasted: int = 0        # prefetched pages never consumed
    # Full-duplex outbound DMA (eviction gathers), modeled.
    evict_pages: int = 0
    evict_dmas: int = 0
    bytes_out: int = 0
    evict_us: float = 0.0
    # Fused gather-attend decode: staged pages read by decode that had
    # landed when its window opened (ready) or arrived inside it
    # (drained), and the µs stalled on transfer tails past the window.
    fused_ready_pages: int = 0
    fused_drained_pages: int = 0
    fused_tail_us: float = 0.0
    # Measured on this engine's device (host clock around synchronised work).
    prefill_s: float = 0.0       # prefill forwards, argmax included
    decode_s: float = 0.0        # decode forwards, argmax included
    d2h_bytes: int = 0           # eviction payloads copied off the device
    d2h_s: float = 0.0
    h2d_bytes: int = 0           # fault-in payloads copied onto the device
    h2d_s: float = 0.0
    landings: int = 0            # page_scatter batches (K and V launch each)
    fused_steps: int = 0         # decode steps that read staged pages
    deadline_hits: Dict[int, int] = dataclasses.field(default_factory=dict)
    deadline_misses: Dict[int, int] = dataclasses.field(default_factory=dict)

    def note_deadline(self, priority: int, hit: bool) -> None:
        d = self.deadline_hits if hit else self.deadline_misses
        d[priority] = d.get(priority, 0) + 1

    def slo_attainment(self, priority: Optional[int] = None
                       ) -> Optional[float]:
        """Fraction of deadline-carrying completions that met their
        deadline, overall or for one priority tier (None when none)."""
        if priority is None:
            hits = sum(self.deadline_hits.values())
            total = hits + sum(self.deadline_misses.values())
        else:
            hits = self.deadline_hits.get(priority, 0)
            total = hits + self.deadline_misses.get(priority, 0)
        return None if total == 0 else hits / total

    @property
    def coalesced_mean(self) -> float:
        return self.coalesced_sum / max(self.decode_steps, 1)

    @property
    def occupancy_mean(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    def tok_per_s(self) -> float:
        if self.wall_s <= 0.0:
            return 0.0
        return (self.prefill_tokens + self.decode_tokens) / self.wall_s

    def summary(self) -> str:
        """One-line summary: throughput, the modeled fault split and
        prefetch and outbound counts, measured PCIe traffic, swaps and CAC
        copies."""
        line = (
            f"{self.tok_per_s():.1f} tok/s | "
            f"{self.prefill_tokens} prefill + {self.decode_tokens} decode "
            f"tok in {self.decode_steps} steps | "
            f"faults {self.faults} in {self.fault_dmas} DMAs "
            f"({self.bytes_in / 1024:.0f} KiB, "
            f"{self.fault_hidden_us:.0f}us hidden / "
            f"{self.fault_exposed_us:.0f}us exposed, modeled) | "
            f"prefetch {self.prefetch_hits}/{self.prefetch_misses}/"
            f"{self.prefetch_wasted} hit/miss/wasted | "
            f"out {self.evict_pages} pages in {self.evict_dmas} DMAs "
            f"({self.bytes_out / 1024:.0f} KiB, modeled) | "
            f"PCIe in {self.h2d_bytes / 2**20:.1f} MiB "
            f"{self.h2d_s * 1e3:.1f} ms, out {self.d2h_bytes / 2**20:.1f} MiB "
            f"{self.d2h_s * 1e3:.1f} ms | "
            f"swaps {self.swaps_out}/{self.swaps_in} | "
            f"CAC copies {self.compaction_copies}")
        if self.fused_ready_pages or self.fused_drained_pages:
            line += (f" | fused {self.fused_ready_pages} ready + "
                     f"{self.fused_drained_pages} drained in-kernel "
                     f"({self.fused_tail_us:.0f}us tail, modeled)")
        att = self.slo_attainment()
        if att is not None:
            line += f" | SLO {att:.1%}"
        return line


def _not_in_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice")


class ServingEngine:
    """The reference's ``ServingEngine`` for one engine, in all three fault
    modes (``fault_mode="async"`` by default, as the reference).

    Keyword names match the reference's constructor.  ``params`` is a
    ``state_dict`` for :class:`~repro_torch.models.lm.LM` (for example from
    :func:`repro_torch.bridge.params_from_jax`); None draws the weights from
    ``torch.Generator`` seeded with ``seed``.  ``device`` defaults to
    ``cuda`` and raises when CUDA is absent; ``device="cpu"`` runs every
    kernel's plain version.  ``dma_channels``, ``prefetch_depth``,
    ``duplex`` and ``slo_urgency_us`` shape the async/fused pipeline as in
    the reference.  ``prefix_cache`` stays ``False`` until the prefix-cache
    slice (True raises).  ``use_pallas``, ``prefill_us_per_token``,
    ``prefix_capacity_pages``, ``engine_id`` and ``translation_kw`` are
    accepted for signature parity and have no effect here: in the reference
    they act only with the prefix cache, the translation meter or in a
    cluster.
    """

    def __init__(self, cfg: ModelConfig, *, geometry: PoolGeometry,
                 max_batch: int, max_seq: int, manager_kind: str = "mosaic",
                 n_shards: int = 1, params: Optional[Mapping] = None,
                 seed: int = 0, use_pallas: bool = False,
                 oversubscription: float = 1.0,
                 link: Optional[LinkModel] = None,
                 fault_mode: str = "async", dma_channels: int = 2,
                 prefetch_depth: int = 2, victim_policy: str = "cost",
                 decode_window_us: Optional[float] = None,
                 prefill_us_per_token: float = 50.0,
                 prefix_cache: bool = False,
                 prefix_capacity_pages: int = 4096,
                 duplex: bool = True,
                 slo_urgency_us: float = 1000.0,
                 host: Optional[HostPageStore] = None,
                 prefix_index=None,
                 engine_id: int = 0,
                 injector=None,
                 translation: str = "off",
                 translation_kw: Optional[dict] = None,
                 device=None):
        if fault_mode not in ("async", "sync", "fused"):
            raise ValueError(
                f"fault_mode must be 'async', 'sync' or 'fused', "
                f"got {fault_mode!r}")
        if fault_mode == "fused" and cfg.mla is not None:
            # The fused path stages dense (k, v) page payloads into the
            # attention kernel; MLA's latent pools cannot consume them.
            raise ValueError("fault_mode='fused' supports dense-attention "
                             "families only (not MLA)")
        if victim_policy not in ("cost", "priority"):
            raise ValueError(
                f"victim_policy must be 'cost' or 'priority', "
                f"got {victim_policy!r}")
        if translation not in ("off", "flat", "radix"):
            raise ValueError(
                f"translation must be 'off', 'flat' or 'radix', "
                f"got {translation!r}")
        if prefix_cache:
            raise _not_in_slice("prefix_cache=True", "prefix cache and "
                                "suffix prefill")
        if translation != "off":
            raise _not_in_slice(f"translation={translation!r}",
                                "translation meter (core/ptw.py)")
        if host is not None or prefix_index is not None:
            raise _not_in_slice("a shared host= / prefix_index=",
                                "cluster and router")
        if injector is not None:
            raise _not_in_slice("injector=", "cluster and router")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "kernels' plain versions")
        self.cfg = cfg
        self.fault_mode = fault_mode
        self.victim_policy = victim_policy
        # Eviction gathers ride the channels' "out" lanes; only the async
        # pipeline has a channel timeline to ride.
        self.duplex = duplex and fault_mode in ("async", "fused")
        # Deadline slack below which a resume candidate counts as urgent
        # for SLO-aware prefetch-depth planning.
        self.slo_urgency_us = slo_urgency_us
        # Modeled compute window per decode step (µs) for the engine clock;
        # None = measured decode wall time.
        self.decode_window_us = decode_window_us
        self.lm = LM(cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.lm.init_weights(gen)
        else:
            self.lm.load_state_dict(params)
        self.geo = geometry
        self.max_batch = max_batch
        self.max_seq = max_seq
        pages_per_seq = (max_seq + geometry.page_tokens - 1) \
            // geometry.page_tokens
        self.mpps = int(np.ceil(pages_per_seq / n_shards
                                / geometry.frame_pages)
                        ) * geometry.frame_pages
        # oversubscription > 1 shrinks the pool below the sized-for-peak
        # working set; the host tier absorbs the overflow.  Sizing is the
        # reference's, so both engines' managers see the same geometry.
        per_shard = int(geometry.pages_for(max_seq, max_batch) / n_shards
                        / max(oversubscription, 1e-9))
        per_shard = max(per_shard, self.mpps)  # ≥ one max-length sequence
        per_shard = ((per_shard + geometry.frame_pages - 1)
                     // geometry.frame_pages) * geometry.frame_pages
        probe = self.lm.pool_shapes(1, geometry.page_tokens)
        # True KV bytes of one base page across all layers (k + v).
        self.page_bytes = sum(int(np.prod(shape[2:])) * shape[0]
                              * dtype.itemsize for shape, dtype in probe)
        self.link = link or LinkModel()
        self.cache = ShardedKVCache(geometry, per_shard, n_shards,
                                    manager_kind, link=self.link,
                                    page_bytes=self.page_bytes)
        self.host = HostPageStore()
        shapes = self.lm.pool_shapes(per_shard * n_shards,
                                     geometry.page_tokens)
        self.pools = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                           for shape, dtype in shapes)
        self.queue: Deque[Request] = deque()
        self.preempted: Deque[Request] = deque()
        self._held: List[Request] = []
        self._saved_tokens: Dict[int, int] = {}
        self.active: List[Request] = []
        self._stalled_steps = 0      # consecutive no-decode steps
        self.stats = EngineStats()
        # Async fault-in pipeline: DMA channel timeline, double-buffered
        # staging and next-step touch predictor, on the modeled µs clock
        # (advanced by the decode window and by exposed stalls).
        self.dma = AsyncDMAEngine(self.link, n_channels=dma_channels,
                                  duplex=duplex)
        self.staging = StagingBuffer()
        self.prefetch = Prefetcher(depth=prefetch_depth)
        self._clock_us = 0.0
        # Fused decode step state: DMA jobs this step's decode consumes
        # (settled at the window end), the staged ((shard, ppn), payload,
        # arrive_us) entries awaiting the post-decode scatter, their copy
        # on the device once decode has read it, and the window-open time.
        self._fused_jobs: List[DMAJob] = []
        self._fused_staged: List[tuple] = []
        self._fused_stage: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._fused_t0 = 0.0

    # ------------------------------------------------------------- helpers

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _index(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- admission

    def submit(self, req: Request):
        self.queue.append(req)

    def _slack(self, r: Request) -> Optional[float]:
        """Deadline slack on the modeled clock (None = no deadline)."""
        if r.deadline_us is None:
            return None
        return r.deadline_us - self._clock_us

    def _slack_or_inf(self, r: Request) -> float:
        s = self._slack(r)
        return float("inf") if s is None else s

    def _admit(self):
        # One admission order across resumes and new arrivals: highest
        # priority first; within a tier, tightest deadline first
        # (deadline-free requests rank last and stay FIFO — max() is
        # stable), and resumes beat arrivals.
        def rank(r: Request):
            return (r.priority, -self._slack_or_inf(r))

        skipped: set = set()     # failed this round; don't block the rest
        while True:
            cand = max((r for r in self.preempted
                        if r.rid not in skipped),
                       key=rank, default=None)
            queued = max((r for r in self.queue if r.rid not in skipped),
                         key=rank, default=None)
            resume = cand is not None and (
                queued is None or cand.priority >= queued.priority)
            if not resume:
                cand = queued
            if cand is None:
                break
            if len(self.active) >= self.max_batch:
                # A premium candidate displaces a strictly-lower-priority
                # active request; with no such victim, stop the round.
                victim = self._pick_victim(below_priority=cand.priority)
                if victim is None:
                    break
                self._preempt(victim)
            ok = self._resume(cand) if resume else self._admit_one(cand)
            if not ok:
                skipped.add(cand.rid)
                continue
            (self.preempted if resume else self.queue).remove(cand)
            self.active.append(cand)
        if not self.active and (self.queue or self.preempted):
            raise RuntimeError(
                "pool cannot hold a single request: shrink max_seq or grow "
                "the pool (oversubscription too aggressive)")

    # --------------------------------------------------- preemption / resume

    def _victim_score(self, r: Request) -> float:
        """Cost of evicting ``r``: resident pages × (priority + 1) ×
        remaining tokens.  Lower = better victim."""
        remaining = max(r.max_new - len(r.out), 1)
        return (float(self.cache.resident_page_count(r.rid))
                * (r.priority + 1) * remaining)

    def _pick_victim(self, *, below_priority: Optional[int] = None,
                     exclude: Tuple[int, ...] = ()) -> Optional[Request]:
        """Cheapest-to-evict active request under the configured policy,
        below ``below_priority`` when given; ties go youngest-first."""
        cands = [r for r in self.active if r.rid not in exclude]
        if below_priority is not None:
            cands = [r for r in cands if r.priority < below_priority]
        if not cands:
            return None
        if self.victim_policy == "priority":
            return min(cands, key=lambda r: (r.priority, -r.rid))
        return min(cands,
                   key=lambda r: (self._victim_score(r), r.priority, -r.rid))

    def _alloc_with_preemption(self, req: Request, n_tokens: int, *,
                               below_priority: Optional[int],
                               exclude: Tuple[int, ...] = ()) -> bool:
        """Allocate with growth headroom, preempting victims as needed.

        An allocation that succeeds but leaves no room for one decode step
        of the batch evicts another victim and retries, so victims are only
        swapped out on a path that ends in admission.  Returns False
        (leaving ``req`` unallocated) when no victim remains.
        """
        while True:
            try:
                self.cache.allocate(req.rid, n_tokens)
            except OutOfMemory:
                self.cache.free(req.rid)   # roll back the partial allocation
                victim = self._pick_victim(below_priority=below_priority,
                                           exclude=exclude + (req.rid,))
                if victim is None:
                    return False
                self._preempt(victim)
                continue
            if self._growth_guard_ok(req):
                return True
            self.cache.free(req.rid)
            victim = self._pick_victim(below_priority=below_priority,
                                       exclude=exclude + (req.rid,))
            if victim is None:
                return False
            self._preempt(victim)

    def _gather_pages(self, entries: List[Tuple[int, int, int]]
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Device→host gather of [(shard, vpn, ppn)] pool pages: one kernel
        launch per pool over all layers, then one copy to the host.
        Returns per-page (k_page, v_page) CPU payloads."""
        if not entries:
            return []
        pps = self.cache.pages_per_shard
        gidx = self._index([s * pps + ppn for s, _v, ppn in entries])
        k, v = self.pools
        kp = kops.page_gather(k, gidx)               # [L, n, ptok, kv, dh]
        vp = kops.page_gather(v, gidx)
        self._sync()
        t0 = time.perf_counter()
        kp, vp = kp.cpu(), vp.cpu()
        self.stats.d2h_s += time.perf_counter() - t0
        self.stats.d2h_bytes += kp.nbytes + vp.nbytes
        return [(kp[:, i], vp[:, i]) for i in range(len(entries))]

    def _enqueue_outbound(self, keys: List[Key],
                          entries: List[Tuple[int, int, int]],
                          payloads: List[Tuple[torch.Tensor, torch.Tensor]],
                          kind: str) -> None:
        """Account a device→host gather on the DMA channels' "out" lanes
        (full duplex).  The host copy is synchronous in the model, so the
        engine never stalls on these jobs: they occupy the outbound
        timeline and settle as hidden µs at the next drain."""
        if not self.duplex or not entries:
            return
        by_shard: Dict[int, List[int]] = {}
        for i, (s, _vpn, _ppn) in enumerate(entries):
            by_shard.setdefault(s, []).append(i)
        for s, idxs in sorted(by_shard.items()):
            job = self.dma.enqueue(
                [keys[i] for i in idxs],
                [entries[i][2] for i in idxs],
                self.cache.mgrs[s].residency.page_bytes,
                [payloads[i] for i in idxs],
                self._clock_us, kind=kind, direction="out")
            self.stats.evict_pages += len(job.keys)
            self.stats.evict_dmas += job.dma_count
            self.stats.bytes_out += job.nbytes
            self.stats.evict_us += job.transfer_us

    def _preempt(self, victim: Request) -> None:
        """Swap a request out: resident pages → host store at base-page
        granularity, pages freed for other tenants."""
        rid = victim.rid
        # Pending compaction plans rewrote tables already; land the payload
        # copies before gathering through those tables.
        self._run_compaction()
        pages = self.cache.mapped_pages(rid)     # [(shard, vpn, ppn)]
        # A just-resumed victim may still hold non-resident pages whose
        # payloads never left the host store: gather only resident ones.
        resident = [
            (s, vpn, ppn) for s, vpn, ppn in pages
            if self.cache.mgrs[s].residency.resident[ppn]
        ]
        payloads = self._gather_pages(resident)
        for (s, vpn, _ppn), (kp, vp) in zip(resident, payloads):
            self.host.put(rid, s, vpn, kp, vp)
        # The gather is outbound DMA traffic on the channels' "out" lanes.
        self._enqueue_outbound([(rid, s, vpn) for s, vpn, _p in resident],
                               resident, payloads, kind="evict")
        self.cache.evict_pages(resident)
        self._saved_tokens[rid] = self.cache.seq_tokens[rid]
        self.cache.free(rid)
        self.active.remove(victim)
        victim.preemptions += 1
        self.preempted.append(victim)
        self.host.note_swap_out()
        self.stats.swaps_out += 1

    def preempt(self, rid: int, *, hold: bool = False) -> bool:
        """Proactively swap an active request out.  It resumes when
        capacity allows, unless ``hold`` is set — a held request stays
        swapped out until :meth:`release`.  False if ``rid`` is not
        active."""
        for r in self.active:
            if r.rid == rid:
                self._preempt(r)
                if hold:
                    self.preempted.remove(r)
                    self._held.append(r)
                return True
        return False

    def release(self, rid: int) -> bool:
        """Make a held request eligible for resume again."""
        for r in self._held:
            if r.rid == rid:
                self._held.remove(r)
                self.preempted.append(r)
                return True
        return False

    def _free_pages_total(self) -> int:
        return sum(m.config.num_pages - int(m.pool.page_allocated.sum())
                   for m in self.cache.mgrs)

    def _growth_guard_ok(self, req: Request) -> bool:
        """Admitting ``req`` must leave room for ≥ one decode step of the
        whole batch (else resume↔preempt livelock)."""
        if not self.active:
            return True          # a sole request always fits (pool ≥ mpps)
        return self._free_pages_total() >= len(self.active) + 2

    def _resume(self, req: Request) -> bool:
        """Re-map a preempted request; payloads fault in on next touch."""
        tokens = self._saved_tokens[req.rid]
        if not self._alloc_with_preemption(req, tokens,
                                           below_priority=req.priority):
            return False
        # Allocation under pressure may have planned compaction: execute the
        # copies before anything reads the rewritten tables.
        self._run_compaction()
        self.cache.demote_host_backed(req.rid, self.host)
        del self._saved_tokens[req.rid]
        self.host.note_swap_in()
        self.stats.swaps_in += 1
        return True

    def _admit_one(self, req: Request) -> bool:
        if not self._alloc_with_preemption(req, len(req.prompt),
                                           below_priority=req.priority):
            return False
        self._prefill_full(req)
        return True

    # --------------------------------------------------- demand fault-in

    def _upload(self, payloads: List[Tuple[torch.Tensor, torch.Tensor]]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy host payloads to the device as [L, n, ptok, n_kv, dh] K and
        V tensors: the host→device transfer of demand paging, timed."""
        kp = torch.stack([p[0] for p in payloads], dim=1)
        vp = torch.stack([p[1] for p in payloads], dim=1)
        self._sync()
        t0 = time.perf_counter()
        kp, vp = kp.to(self.device), vp.to(self.device)
        self._sync()
        self.stats.h2d_s += time.perf_counter() - t0
        self.stats.h2d_bytes += kp.nbytes + vp.nbytes
        return kp, vp

    def _land(self, gidx: List[int], kp: torch.Tensor,
              vp: torch.Tensor) -> None:
        """Scatter device-resident pages into the pools at global page ids
        ``gidx``: one kernel launch per pool over all layers."""
        idx = self._index(gidx)
        k, v = self.pools
        kops.page_scatter(k, idx, kp)
        kops.page_scatter(v, idx, vp)
        self.stats.landings += 1

    def _scatter_pages(self, gidx: List[int],
                       payloads: List[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> None:
        """Land faulted host payloads in the device pools."""
        if not gidx:
            return
        self._land(gidx, *self._upload(payloads))

    def _fault_in(self, seqs: List[int]) -> None:
        """touch() this step's pages and fault the missing ones in: blocking
        under ``"sync"``, staged and overlapped under ``"async"``, resolved
        to decode-time sources under ``"fused"``."""
        if self.fault_mode == "sync":
            self._fault_in_sync(seqs)
        elif self.fault_mode == "fused":
            self._fault_in_fused(seqs)
        else:
            self._fault_in_async(seqs)

    def _fault_in_sync(self, seqs: List[int]) -> None:
        """The blocking path: the whole batch stalls on the transfer, so
        every µs is exposed."""
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return
        pps = self.cache.pages_per_shard
        gidx: List[int] = []
        payloads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        step_us = 0.0
        for s, entries in missing.items():
            batch = self.cache.mgrs[s].residency.fault_in(
                [ppn for ppn, _o, _v in entries])
            self.stats.faults += len(batch.ppns)
            self.stats.fault_dmas += batch.dma_count
            self.stats.bytes_in += batch.nbytes
            self.stats.transfer_us += batch.transfer_us
            self.stats.fault_exposed_us += batch.transfer_us
            step_us += batch.transfer_us
            for ppn, owner, vpn in entries:
                gidx.append(s * pps + ppn)
                payloads.append(self.host.pop(owner, s, vpn))
        self.stats.fault_steps += 1
        self._clock_us += step_us       # the whole transfer stalls the step
        self._scatter_pages(gidx, payloads)

    def _consume_hit(self, s: int, ppn: int, key: Key) -> None:
        """Book a miss served by a staged or in-flight prefetch: the page
        is resident from now on and its host copy is retired."""
        self.cache.mgrs[s].residency.mark_resident([ppn])
        self.host.pop(*key)
        self.stats.faults += 1
        self.stats.prefetch_hits += 1
        self.prefetch.stats["hits"] += 1

    def _demand(self, s: int, demand: List[Tuple[int, int, int]], now: float
                ) -> Tuple[DMAJob, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Fault the never-predicted misses of shard ``s`` in as one demand
        job on the channels (queued behind in-flight prefetches)."""
        self.cache.mgrs[s].residency.fault_in([ppn for ppn, _o, _v in demand])
        dpay = [self.host.pop(owner, s, vpn) for _ppn, owner, vpn in demand]
        job = self.dma.enqueue(
            [(owner, s, vpn) for _p, owner, vpn in demand],
            [ppn for ppn, _o, _v in demand],
            self.cache.mgrs[s].residency.page_bytes, dpay, now,
            kind="demand")
        self.stats.faults += len(demand)
        self.stats.fault_dmas += job.dma_count
        self.stats.bytes_in += job.nbytes
        self.stats.transfer_us += job.transfer_us
        self.stats.prefetch_misses += len(demand)
        self.prefetch.stats["misses"] += len(demand)
        return job, dpay

    def _restage_leftovers(self, waited: Dict[Key, tuple]) -> None:
        """Payloads of a waited multi-page job whose keys were not touched
        this step stay staged for later steps; a key whose owner retired
        mid-flight is wasted transfer."""
        for key, payload in waited.items():
            if self.host.has(*key):
                self.staging.stage(key, payload)
            else:
                self.prefetch.stats["wasted_pages"] += 1
                self.stats.prefetch_wasted += 1

    def _fault_in_async(self, seqs: List[int]) -> None:
        """Serve this step's misses from staging (hidden), stall on
        in-flight prefetches (partially hidden), and demand-fault only the
        never-predicted remainder (exposed).  The payloads then land
        through the same upload and scatter as sync mode."""
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return
        pps = self.cache.pages_per_shard
        now = self._clock_us
        gidx: List[int] = []
        payloads: List[Tuple[torch.Tensor, torch.Tensor]] = []
        waited: Dict[Key, tuple] = {}
        for s, entries in sorted(missing.items()):
            demand: List[Tuple[int, int, int]] = []
            for ppn, owner, vpn in entries:
                key = (owner, s, vpn)
                payload = waited.pop(key, None)
                if payload is None:
                    payload = self.staging.consume(key)
                if payload is None and key in self.prefetch.in_flight:
                    # Started during the previous decode: stall only for
                    # the remainder of its transfer.
                    job = self.prefetch.in_flight[key]
                    now = self.dma.wait(job, now)
                    self.prefetch.forget(job.keys)
                    waited.update(zip(job.keys, job.payloads))
                    payload = waited.pop(key)
                if payload is None:
                    demand.append((ppn, owner, vpn))
                    continue
                self._consume_hit(s, ppn, key)
                gidx.append(s * pps + ppn)
                payloads.append(payload)
            if demand:
                job, dpay = self._demand(s, demand, now)
                now = self.dma.wait(job, now)
                for (ppn, _o, _v), p in zip(demand, dpay):
                    gidx.append(s * pps + ppn)
                    payloads.append(p)
        self._restage_leftovers(waited)
        self.stats.fault_steps += 1
        # Engine-level exposed = the step's stall (channel queueing
        # included); the DMA engine keeps the strict per-transfer split.
        self.stats.fault_exposed_us += now - self._clock_us
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]
        self._clock_us = now
        self._scatter_pages(gidx, payloads)

    # ------------------------------------------------ fused decode path

    def _write_page_set(self, seqs: List[int]) -> set:
        """(shard, ppn) of each sequence's current write page, the page
        this step's token lands in.  A staged write page is merged into
        the pool before decode: attention would otherwise read the staged
        bytes without the new token."""
        ftok = self.geo.frame_pages * self.geo.page_tokens
        out = set()
        for seq in seqs:
            pos = self.cache.seq_tokens[seq] - 1
            s = self.cache._shard_of_frame(pos // ftok)
            table = self.cache.mgrs[s].tables[seq]
            out.add((s, table.ppn[len(table.ppn) - 1]))
        return out

    def _fault_in_fused(self, seqs: List[int]) -> None:
        """Resolve this step's misses to sources (staged payloads,
        in-flight prefetch jobs, fresh demand jobs) without waiting on any
        transfer.  Decode reads them from the step's stage
        (:meth:`_attach_staging`); the collected jobs settle against the
        end of the decode window (:meth:`_settle_fused`)."""
        self._fused_jobs = []
        self._fused_staged = []
        self._fused_stage = None
        self._fused_t0 = self._clock_us
        missing = self.cache.missing_pages(seqs)
        if not missing:
            return
        now = self._clock_us
        pps = self.cache.pages_per_shard
        write_pages = self._write_page_set(seqs)
        jobs: Dict[int, DMAJob] = {}
        waited: Dict[Key, tuple] = {}
        arrive: Dict[Key, float] = {}
        for s, entries in sorted(missing.items()):
            demand: List[Tuple[int, int, int]] = []
            for ppn, owner, vpn in entries:
                key = (owner, s, vpn)
                when = now          # staging hits landed before this step
                payload = waited.pop(key, None)
                if payload is not None:
                    when = arrive.get(key, now)
                if payload is None:
                    payload = self.staging.consume(key)
                if payload is None and key in self.prefetch.in_flight:
                    # In flight: read in-kernel, do not stall; record the
                    # page's modeled arrival.
                    job = self.prefetch.in_flight[key]
                    jobs[job.job_id] = job
                    self.prefetch.forget(job.keys)
                    for i2, (k2, p2) in enumerate(
                            zip(job.keys, job.payloads)):
                        waited[k2] = p2
                        arrive[k2] = job.page_done_us(i2)
                    payload = waited.pop(key)
                    when = arrive[key]
                if payload is None:
                    demand.append((ppn, owner, vpn))
                    continue
                self._consume_hit(s, ppn, key)
                self._fused_staged.append(((s, ppn), payload, when))
            if demand:
                job, dpay = self._demand(s, demand, now)
                jobs[job.job_id] = job
                for i2, ((ppn, _o, _v), p) in enumerate(zip(demand, dpay)):
                    self._fused_staged.append(
                        ((s, ppn), p, job.page_done_us(i2)))
        self._restage_leftovers(waited)
        self._fused_jobs = sorted(jobs.values(), key=lambda j: j.job_id)
        # The write page lands now (this step's token write mutates it);
        # everything else stays staged for decode.  Its job still settles
        # at the window end.
        pre = [(sp, pl) for sp, pl, _t in self._fused_staged
               if sp in write_pages]
        if pre:
            self._scatter_pages([s * pps + p for (s, p), _pl in pre],
                                [pl for _sp, pl in pre])
            self._fused_staged = [e for e in self._fused_staged
                                  if e[0] not in write_pages]
        self.stats.fault_steps += 1

    def _attach_staging(self, ctx: PageCtx) -> PageCtx:
        """Hand decode this step's staged pages: one host→device copy of
        their payloads as the stage [L, NS, ptok, n_kv, dh] (contiguous
        per layer), and a slot table shaped like ``ctx.tables`` (-1 = read
        the pool).  The reference pads NS to a power of two to bound jit
        retraces; eager PyTorch has none, so NS is exact."""
        if not self._fused_staged:
            return ctx
        pps = self.cache.pages_per_shard
        gidx = [s * pps + ppn for (s, ppn), _pl, _t in self._fused_staged]
        lut = torch.full((self.cache.S * pps,), -1, dtype=torch.int32)
        lut[torch.tensor(gidx)] = torch.arange(len(gidx), dtype=torch.int32)
        lut = lut.to(self.device)
        slots = torch.where(ctx.tables >= 0,
                            lut[ctx.tables.clamp(min=0).long()], -1)
        kp, vp = self._upload([pl for _sp, pl, _t in self._fused_staged])
        self._fused_stage = (kp, vp)
        self.stats.fused_steps += 1
        return dataclasses.replace(ctx, slots=slots.contiguous(),
                                   stage_k=kp, stage_v=vp)

    def _settle_fused(self) -> None:
        """Post-decode sync point: the collected jobs settle against the
        window end (transfer µs inside the window are hidden, tails past
        it exposed), then the staged pages are scattered into the pool
        from the copy :meth:`_attach_staging` put on the device, so the
        pool is authoritative again before any eviction gathers.  (The
        reference also settles when a spill loss leaves no row to decode;
        that path comes with the cluster slice's spill tier.)"""
        t_end = self._clock_us
        now = t_end
        for job in self._fused_jobs:
            now = max(now, self.dma.wait(job, t_end))
        if self._fused_jobs:
            self.stats.fault_exposed_us += now - t_end
            self.stats.fused_tail_us += now - t_end
            self._clock_us = now
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]
        self._fused_jobs = []
        if self._fused_staged:
            t0 = self._fused_t0
            ready = sum(1 for _sp, _pl, t in self._fused_staged if t <= t0)
            self.stats.fused_ready_pages += ready
            self.stats.fused_drained_pages += \
                len(self._fused_staged) - ready
            pps = self.cache.pages_per_shard
            self._land([s * pps + p for (s, p), _pl, _t in self._fused_staged],
                       *self._fused_stage)
            self._fused_staged = []
            self._fused_stage = None

    # --------------------------------------------- async prefetch pipeline

    def _drain_prefetches(self) -> None:
        """Step start: publish the transfers that completed during the
        previous decode into the staging front buffer (double-buffer
        swap)."""
        for job in self.dma.drain(self._clock_us):
            if job.direction == "out":
                continue    # outbound gathers: settled by drain, no staging
            self.prefetch.forget(job.keys)
            for key, payload in zip(job.keys, job.payloads):
                if self.host.has(*key):
                    self.staging.stage(key, payload)
                else:   # owner retired while the DMA was in flight
                    self.prefetch.stats["wasted_pages"] += 1
                    self.stats.prefetch_wasted += 1
        self.staging.swap()
        self.stats.fault_hidden_us = self.dma.stats["hidden_us"]

    def _resume_candidates(self) -> List[Request]:
        """Resume candidates in the order _admit considers them: highest
        priority first; within a tier tightest deadline slack first,
        deadline-free requests FIFO last (stable sort)."""
        return sorted(self.preempted,
                      key=lambda r: (-r.priority, self._slack_or_inf(r)))

    def _issue_prefetch(self) -> None:
        """Just before decode: issue the predicted next-step touches to the
        DMA channels so they transfer while this step computes.  The
        resume-prefetch window widens with the resume queue's deadline
        pressure (``Prefetcher.plan_depth``)."""
        resume = self._resume_candidates()
        depth = self.prefetch.plan_depth(
            [self._slack(r) for r in resume], self.slo_urgency_us)
        preds = self.prefetch.predict(
            self.cache, self.host, [r.rid for r in self.active],
            [r.rid for r in resume], depth=depth)
        by_shard: Dict[int, List[Tuple[Key, int]]] = {}
        by_seq: Dict[int, List[Key]] = {}
        for key, ppn in preds:
            if self.staging.contains(key) or key in self.prefetch.in_flight:
                continue        # already staged or on a channel
            if not self.host.has(*key):
                continue
            if ppn is not None:
                by_shard.setdefault(key[1], []).append((key, ppn))
            else:
                by_seq.setdefault(key[0], []).append(key)
        jobs = []
        for s, group in sorted(by_shard.items()):
            # Mapped targets: real ppns drive the contiguous-run cost.
            jobs.append(self.dma.enqueue(
                [k for k, _p in group], [p for _k, p in group],
                self.page_bytes, [self.host.peek(*k) for k, _p in group],
                self._clock_us, kind="prefetch"))
        for rid, keys in sorted(by_seq.items()):
            # Resume candidates have no frames yet: the transfer gathers
            # into contiguous staging slots, so it merges into one DMA.
            jobs.append(self.dma.enqueue(
                keys, list(range(len(keys))), self.page_bytes,
                [self.host.peek(*k) for k in keys],
                self._clock_us, kind="prefetch"))
        for job in jobs:
            for key in job.keys:
                self.prefetch.in_flight[key] = job
            self.prefetch.stats["issued_pages"] += len(job.keys)
            self.stats.fault_dmas += job.dma_count
            self.stats.bytes_in += job.nbytes
            self.stats.transfer_us += job.transfer_us

    # --------------------------------------------------------- prefill

    def _prefill_full(self, req: Request):
        """Full-prompt forward for an already-allocated request."""
        ptok = self.geo.page_tokens
        T = len(req.prompt)
        Tpad = ((T + ptok - 1) // ptok) * ptok
        # Allocation under memory pressure may have compacted: the tables
        # already point at the new locations, so the data copies must land
        # before the device reads them (and before the pages freed by
        # compaction are overwritten by this prefill).
        self._run_compaction()
        t0 = time.perf_counter()
        ctx = self._ctx_global(self.cache.pack_ctx(
            [req.rid], self.mpps, device=self.device))
        tokens = torch.zeros((1, Tpad), dtype=torch.int32)
        tokens[0, :T] = torch.from_numpy(np.asarray(req.prompt, np.int32))
        logits, _ = self.lm.prefill(
            {"tokens": tokens.to(self.device)}, self.pools, ctx,
            last_pos=self._index([T - 1]))
        req.out.append(int(torch.argmax(logits[0])))
        self.stats.prefill_s += time.perf_counter() - t0
        # Tokens beyond T within the padded page are unused; the tracked
        # length stays T (+1 for the decode append).
        self.stats.prefill_tokens += T

    def _ctx_global(self, ctx: PageCtx) -> PageCtx:
        """Convert per-shard local page ids to global pool ids (global id =
        shard * pages_per_shard + local id)."""
        if self.cache.S == 1:
            return ctx
        pps = self.cache.pages_per_shard
        off = torch.arange(self.cache.S, dtype=torch.int32,
                           device=ctx.tables.device) * pps
        tables = torch.where(ctx.tables >= 0, ctx.tables + off[None, :, None],
                             -1)
        wpage = torch.where(ctx.wpage >= 0, ctx.wpage + off[None, :], -1)
        return dataclasses.replace(ctx, tables=tables, wpage=wpage)

    # ------------------------------------------------------------- stepping

    def _append_with_preemption(self) -> List[Request]:
        """Grow active requests by one token slot, highest priority first.

        Under pool pressure a request may displace peers of its own tier or
        below; with no displaceable victim it stalls this step.  If nobody
        can grow, the lowest-priority request is swapped out so the rest
        make progress next step.  Returns this step's decode batch.
        """
        order = sorted(self.active, key=lambda r: -r.priority)  # stable
        appended: List[Request] = []
        for r in order:
            if r not in self.active:
                continue            # preempted as someone else's victim
            while r in self.active:
                try:
                    self.cache.append(r.rid, 1)
                    appended.append(r)
                    break
                except OutOfMemory:
                    victim = self._pick_victim(
                        below_priority=r.priority + 1,
                        exclude=tuple(a.rid for a in appended) + (r.rid,))
                    if victim is None:
                        break       # stall: retry next step
                    self._preempt(victim)
        if not appended and self.active:
            victim = self._pick_victim()
            if victim is not None and len(self.active) > 1:
                self._preempt(victim)
        return [r for r in self.active if r in appended]

    def step(self) -> bool:
        """One engine iteration: (async/fused: drain completed prefetches)
        → admit → grow → compact → fault in → decode (async/fused: while
        the next step's prefetches are in flight) → (fused: settle) →
        retire."""
        t0 = time.perf_counter()
        if self.fault_mode in ("async", "fused"):
            # Publish transfers that finished during the last decode so
            # admission's resumes and this step's fault-in see them.
            self._drain_prefetches()
        self._admit()
        if not self.active:
            self.stats.wall_s += time.perf_counter() - t0
            return False
        runnable = self._append_with_preemption()
        if not runnable:
            # A permanent stall means some request can never grow: fail
            # loudly rather than spinning to the step cap.
            self._stalled_steps += 1
            if self._stalled_steps > 64:
                raise OutOfMemory(
                    f"engine stalled {self._stalled_steps} consecutive "
                    f"steps: active requests "
                    f"{sorted(r.rid for r in self.active)} cannot grow "
                    f"(pool too small or fragmentation unrecoverable)")
            self.stats.wall_s += time.perf_counter() - t0
            return bool(self.active or self.queue or self.preempted)
        self._stalled_steps = 0
        seqs = [r.rid for r in runnable]
        # Appends under pressure may compact: execute the copy plan before
        # decode consumes the updated tables.
        self._run_compaction()
        self._fault_in(seqs)
        ctx = self._ctx_global(self.cache.pack_ctx(seqs, self.mpps,
                                                   device=self.device))
        if self.fault_mode == "fused":
            # Decode on what is resident plus this step's staged arrivals.
            ctx = self._attach_staging(ctx)
        if self.fault_mode in ("async", "fused"):
            # Predicted next-step touches ride the channels during decode.
            self._issue_prefetch()
        t_dec = time.perf_counter()
        toks = self._index([r.out[-1] for r in runnable])
        pos = self._index([self.cache.seq_tokens[r.rid] - 1
                           for r in runnable])
        logits, _ = self.lm.decode_step(toks, pos, self.pools, ctx)
        nxt = logits.argmax(dim=-1).cpu().tolist()
        dt = time.perf_counter() - t_dec
        self.stats.decode_s += dt
        # The decode step is the window in-flight transfers hide in: the
        # modeled width if configured, else the measured time.
        self._clock_us += (self.decode_window_us
                           if self.decode_window_us is not None
                           else dt * 1e6)
        if self.fault_mode == "fused":
            # Settle the consumed jobs (only tails past the window are
            # exposed) and scatter the staged pages before any eviction.
            self._settle_fused()
        done_now = []
        for i, r in enumerate(runnable):
            r.out.append(int(nxt[i]))
            self.stats.decode_tokens += 1
            if len(r.out) >= r.max_new \
                    or self.cache.seq_tokens[r.rid] >= self.max_seq - 1:
                r.done = True
                done_now.append(r)
                if r.deadline_us is not None:
                    self.stats.note_deadline(
                        r.priority, self._clock_us <= r.deadline_us)
        for r in done_now:
            self.active.remove(r)
            self.cache.free(r.rid)
            self.host.drop_seq(r.rid)
            dropped = self.staging.invalidate_seq(r.rid)
            self.stats.prefetch_wasted += dropped
            self.prefetch.stats["wasted_pages"] += dropped
            self.prefetch.cancel_seq(r.rid)
            self._saved_tokens.pop(r.rid, None)
        self._run_compaction()
        st = self.cache.stats()
        self.stats.coalesced_sum += st.get("coalesced_fraction", 0.0)
        self.stats.occupancy_sum += st.get("occupancy", 0.0)
        self.stats.decode_steps += 1
        self.stats.wall_s += time.perf_counter() - t0
        return True

    def _run_compaction(self):
        """Execute pending CAC copy plans on the device (one kernel launch
        per pool over all layers)."""
        ops = self.cache.drain_copy_ops()
        if not ops:
            return
        pps = self.cache.pages_per_shard
        src = self._index([s * pps + op.src_ppn for s, op in ops])
        dst = self._index([s * pps + op.dst_ppn for s, op in ops])
        k, v = self.pools
        kops.page_compact(k, src, dst)
        kops.page_compact(v, src, dst)
        self.stats.compaction_copies += len(ops)

    # ------------------------------------------------------------- run

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while (self.queue or self.active or self.preempted) \
                and steps < max_steps:
            self.step()
            steps += 1
        if self.fault_mode in ("async", "fused") and not (
                self.queue or self.active or self.preempted):
            # Settle transfers still on the channels so the hidden/exposed/
            # wasted split covers every issued byte.
            self._clock_us = max(self._clock_us, self.dma.busy_until())
            self._drain_prefetches()
        return steps
