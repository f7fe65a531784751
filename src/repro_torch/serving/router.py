"""Deadline-aware request router + work-stealing migration (DESIGN.md §10/§14).

The cluster front door: requests are submitted to the router, not to an
engine.  Each router step runs four phases:

1. **Dispatch** — pending requests are assigned to engines.  Under the
   default ``policy="slack"`` the pending set is ordered highest
   priority first, tightest deadline first within a tier (deadline-free
   requests last, rid order — the same rank the engines' own admission
   loops use, so the cluster and the engine agree about who is urgent),
   and each request goes to the **cheapest** engine at that moment:
   :meth:`engine_cost_us`, a modeled-µs completion estimate built from
   the engine's wall clock, its DMA link-lane occupancy, its batched
   decode backlog (critical path vs throughput), and — when a shared
   tier is attached — disk promote debt and write-back (host-lane)
   occupancy
   (DESIGN.md §14).  ``cost_model="tokens"`` keeps the original token-count
   heuristic for A/B benches; ``policy="fifo"`` keeps arrival order and
   round-robins engines.
2. **Step** — every engine with work runs one
   :meth:`~repro_torch.serving.engine.ServingEngine.step`.  Afterwards the
   engines' modeled µs clocks are synced to the cluster maximum: the
   cluster has *one* wall clock, so deadlines and slack mean the same
   thing on every replica (the sync only moves idle clocks forward —
   it never rewinds, and it never touches model state, so tokens are
   unaffected).
3. **Steal (preempted)** — if an engine holds preempted requests it
   cannot resume (batch full, or no pool headroom) while another engine
   has spare batch slots *and* enough free pages, the best resume
   candidate (priority, then slack) migrates: the source engine exports
   its pure host-side bundle (Request + decode state + saved token
   count), the shared tier re-leases the request's host frames to the
   destination domain (whole-frame owner flips when exclusive — zero
   copies), and the destination imports it into its resume queue.  The
   request then faults in through the destination's own DMA lanes and
   continues decoding — **no re-prefill, no device-to-device copy**.
4. **Steal (queued)** — a *queued, never-admitted* request is pure
   router state (no device KV, no host leases), so re-dispatching it is
   free.  At most one moves per step, under a deterministic rule
   (DESIGN.md §14): the cheapest engine takes the most urgent
   non-pinned queued request of the costliest engine, and only when the
   source stays strictly costlier than the destination *plus* the
   request's own cost — the hysteresis that makes ping-pong impossible.

**Proactive pre-staging** (DESIGN.md §14, opt-in via ``prestage=True``):
the moment dispatch (or a queued steal) picks a target engine, the
request's prefix-index hits and resume pages start faulting toward that
engine's staging buffers over the ordinary prefetch DMA "in" lanes —
admission later finds the transfers staged or in flight and skips
issuing them again.  A steal or crash that retargets the request
cancels its pre-stage with a lane-time refund for the un-elapsed
transfer remainder.  Pre-staging only moves *when* bytes arrive, never
what decode computes: tokens are byte-identical with it on or off.

Migration requires the shared host tier (without it the payload bytes
live in the source engine's private store); the router degrades to
dispatch-only when ``tier`` is None.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass
class RouterStats:
    submitted: int = 0
    dispatched: Dict[int, int] = dataclasses.field(default_factory=dict)
    migrations: int = 0
    migrated_pages: int = 0
    steal_rounds: int = 0            # steal scans that found a candidate
    # Failure recovery (DESIGN.md §12): injected engine deaths, preempted
    # bundles re-homed to survivors (zero re-prefill), and in-flight or
    # queued victims re-dispatched from the prompt.
    crashes: int = 0
    recovered_bundles: int = 0
    recovered_requeued: int = 0
    # Queued-work re-dispatch + proactive pre-staging (DESIGN.md §14).
    queued_steals: int = 0
    prestaged_requests: int = 0
    prestage_cancels: int = 0
    prestage_refund_us: float = 0.0


class RequestRouter:
    def __init__(self, engines: List[ServingEngine], *, tier=None,
                 policy: str = "slack", migrate: bool = True,
                 injector=None, cost_model: str = "modeled",
                 prestage: bool = False,
                 steal_queued: bool = True,
                 translation_aware: bool = True) -> None:
        assert policy in ("slack", "fifo"), policy
        assert cost_model in ("modeled", "tokens"), cost_model
        assert engines
        self.engines = engines
        self.tier = tier
        self.policy = policy
        self.cost_model = cost_model
        # Translation-interference term (DESIGN.md §15): charge each
        # engine's booked walker backlog in the modeled dispatch cost.
        # With the engines' translation meters off the term is 0.0, so
        # this default changes nothing for meter-less clusters.
        self.translation_aware = translation_aware
        # Proactive pre-staging of queued requests (DESIGN.md §14).
        self.prestage = prestage
        # Queued-steal is gated separately from preempted-steal: a queued
        # request carries no host-side state, so it needs no tier.
        self.steal_queued = steal_queued
        # Work stealing needs the shared tier: the bundle is host-side
        # state, and the payload bytes must be visible to the thief.
        self.migrate = migrate and tier is not None
        # Failure injection (DESIGN.md §12): scheduled engine crashes
        # fire at the start of their router step.
        self.injector = injector
        self._step_no = 0
        self.pending: List[Tuple[int, Request]] = []    # (arrival, req)
        self._arrival = itertools.count()
        self._rr = 0                                    # fifo round-robin
        self._owner: Dict[int, int] = {}                # rid → engine idx
        # rid → engine idx its pre-stage targets.  Invariant: an entry
        # exists only while the request sits in that engine's queue —
        # pruned after each step, cancelled on steal/crash retarget —
        # so a crash can never double-cancel (or double-stage) a rid.
        self._prestaged: Dict[int, int] = {}
        # Explicitly placed rids (submit(engine=...)): benches pin these
        # to construct controlled scenarios — queued-steal respects that
        # and never re-dispatches them.
        self._pinned: set = set()
        self.stats = RouterStats()

    def _live(self) -> List[ServingEngine]:
        return [e for e in self.engines if e.alive]

    # ------------------------------------------------------------- submit

    def submit(self, req: Request, engine: Optional[int] = None) -> None:
        """Queue a request for dispatch; ``engine`` pins it to a replica
        (benches use this to construct controlled scenarios)."""
        assert req.rid not in self._owner \
            and all(r.rid != req.rid for _, r in self.pending), \
            f"rid {req.rid} already routed (cluster rids must be unique)"
        self.stats.submitted += 1
        if engine is not None:
            self._pinned.add(req.rid)
            self._assign(req, engine)
        else:
            self.pending.append((next(self._arrival), req))

    def _assign(self, req: Request, idx: int) -> None:
        self._owner[req.rid] = idx
        self.engines[idx].submit(req)
        self.stats.dispatched[idx] = self.stats.dispatched.get(idx, 0) + 1
        self._prestage_to(req, idx)

    # --------------------------------------------------------- pre-staging

    def _prestage_to(self, req: Request, idx: int) -> None:
        """Start faulting ``req``'s reusable pages toward engine ``idx``
        (DESIGN.md §14).  Exactly-once discipline: any stale pre-stage
        at another engine is cancelled first, and the tracking entry is
        recorded only when pages were actually issued."""
        if not self.prestage:
            return
        if self._prestaged.get(req.rid, idx) != idx:
            self._cancel_prestage(req.rid)
        staged = self.engines[idx].prestage_queued(req)
        if staged:
            self._prestaged[req.rid] = idx
            self.stats.prestaged_requests += 1

    def _cancel_prestage(self, rid: int) -> None:
        """Cancel ``rid``'s pre-stage at whichever engine holds it (a
        steal or crash retargeted the request).  The un-elapsed lane
        time refunded by the DMA engine is accounted cluster-side."""
        idx = self._prestaged.pop(rid, None)
        if idx is None:
            return
        refund = self.engines[idx].cancel_prestage(rid)
        self.stats.prestage_cancels += 1
        self.stats.prestage_refund_us += refund

    def _prune_prestaged(self) -> None:
        """Drop tracking entries whose request left the target engine's
        queue (admitted, or retired) — the engine-side accounting took
        over at admission.  Keeping them would make a later crash
        "cancel" staged payloads an admission already dedup'd against."""
        for rid, idx in list(self._prestaged.items()):
            if all(r.rid != rid for r in self.engines[idx].queue):
                del self._prestaged[rid]

    # ------------------------------------------------------------- dispatch

    @staticmethod
    def engine_load(eng: ServingEngine) -> int:
        """Outstanding-work estimate in page-ish units: remaining decode
        tokens of admitted/preempted requests plus prompt pages + decode
        tokens of the still-queued.  The original heuristic, kept as the
        ``cost_model="tokens"`` A/B baseline: cheap and consistent, but
        blind to the *rate* at which each unit retires — a decode token
        costs a whole batched window while a prompt token costs only
        ``prefill_us_per_token``, so token counts misroute whenever the
        mix is heterogeneous (the ``router`` bench scenario)."""
        ptok = max(eng.geo.page_tokens, 1)
        load = 0
        for r in list(eng.active) + list(eng.preempted):
            load += max(r.max_new - len(r.out), 1)
        for r in eng.queue:
            load += len(r.prompt) // ptok + max(r.max_new - len(r.out), 1)
        return load

    def engine_cost_us(self, eng: ServingEngine) -> float:
        """Modeled µs until ``eng`` would drain the work it already owns
        (DESIGN.md §14) — the dispatch cost a newcomer queues behind.

        Terms, all from state the engine/tier already track:

        * **link lanes** — DMA backlog beyond the engine's clock
          (``dma.busy_until()``): transfers a new admission's fault-ins
          queue behind;
        * **decode backlog** — remaining new tokens across active /
          preempted / held / queued requests.  Window count is the max
          of the throughput bound (total remaining / ``max_batch``) and
          the critical path (largest single request's remaining tokens,
          since a request retires at most one token per window);
        * prefill carries **no term**: on the modeled clock admission
          compute is wall work hidden inside the decode window, so
          queued prompt pages are free — exactly the heterogeneity the
          token-count baseline overweights (its misroute the ``router``
          bench demonstrates);
        * **disk lanes** — each preempted/held request whose saved pages
          spilled owes one seek + per-page disk reads before it can
          resume;
        * **host lanes** — the shared tier's write-back DMA backlog
          (identical for every engine, but it keeps absolute costs
          honest for hysteresis thresholds);
        * **walker backlog** — booked page-walk time on the engine's
          MMU (DESIGN.md §15), when ``translation_aware`` and the
          engine's translation meter is on.

        Monotone by construction: adding a request, a DMA booking, or a
        spilled page can only raise the cost.  The sim-side mirror is
        :meth:`repro_torch.core.tlb_sim.Link.engine_occupancy`.
        """
        now = eng._clock_us
        window = (eng.decode_window_us
                  if eng.decode_window_us is not None else 1000.0)
        cost = max(0.0, eng.dma.busy_until() - now)
        remaining = 0
        longest = 0
        for r in (list(eng.active) + list(eng.preempted)
                  + list(eng._held) + list(eng.queue)):
            rem = max(r.max_new - len(r.out), 1)
            remaining += rem
            longest = max(longest, rem)
        if remaining:
            cost += window * max(-(-remaining // max(eng.max_batch, 1)),
                                 longest)
        if self.tier is not None:
            for r in list(eng.preempted) + list(eng._held):
                spilled = self.tier.spilled_keys_of(r.rid)
                if spilled:
                    cost += (self.tier.disk_seek_us + len(spilled)
                             * self.tier.disk_read_us_per_page)
            wb = getattr(self.tier, "wb_dma", None)
            if wb is not None:
                cost += max(0.0, wb.busy_until() - now)
        if self.translation_aware:
            # Walker backlog (DESIGN.md §15): a newcomer's translations
            # queue behind the booked walks of the engine's MMU.  0.0
            # when the engine's translation meter is off — the term is
            # inert unless translation modeling was asked for.  Monotone:
            # booking a walk can only raise the backlog.
            cost += eng.translation_backlog_us()
        return cost

    def _load(self, eng: ServingEngine) -> float:
        """The active cost model's load figure for ``eng``."""
        if self.cost_model == "tokens":
            return float(self.engine_load(eng))
        return self.engine_cost_us(eng)

    def _request_cost(self, r: Request, eng: ServingEngine) -> float:
        """What ``r`` itself would add to ``eng``'s load figure — the
        queued-steal hysteresis margin, in the active model's units."""
        rem = max(r.max_new - len(r.out), 1)
        if self.cost_model == "tokens":
            ptok = max(eng.geo.page_tokens, 1)
            return float(len(r.prompt) // ptok + rem)
        window = (eng.decode_window_us
                  if eng.decode_window_us is not None else 1000.0)
        return window * (-(-rem // max(eng.max_batch, 1)))

    def _rank(self, item: Tuple[int, Request]):
        arrival, r = item
        deadline = r.deadline_us if r.deadline_us is not None \
            else float("inf")
        # rid (not arrival) breaks equal-slack ties: submission-order
        # shuffles of equivalent requests must not change the dispatch
        # (the §14 determinism property) — arrival stays as the final
        # tiebreak for the degenerate duplicate-rid case.
        return (-r.priority, deadline, r.rid, arrival)

    def dispatch(self) -> None:
        if not self.pending:
            return
        live = [i for i, e in enumerate(self.engines) if e.alive]
        assert live, "no live engine to dispatch to"
        if self.policy == "slack":
            order = sorted(self.pending, key=self._rank)
            for _, req in order:
                idx = min(live,
                          key=lambda i: (self._load(self.engines[i]), i))
                self._assign(req, idx)
        else:                           # fifo: arrival order, round-robin
            for _, req in sorted(self.pending):
                while not self.engines[self._rr].alive:
                    self._rr = (self._rr + 1) % len(self.engines)
                self._assign(req, self._rr)
                self._rr = (self._rr + 1) % len(self.engines)
        self.pending.clear()

    # ------------------------------------------------------------- stepping

    def _busy(self, eng: ServingEngine) -> bool:
        if not eng.alive:
            return False
        return bool(eng.queue or eng.active or eng.preempted)

    def step(self) -> bool:
        if self.injector is not None:
            for idx in self.injector.crashes_due(self._step_no):
                self._crash(idx)
        self._step_no += 1
        self.dispatch()
        progressed = False
        for eng in self.engines:
            if self._busy(eng):
                progressed = bool(eng.step()) or progressed
        # One cluster wall clock: idle replicas' modeled clocks advance
        # with the busy ones, so slack/deadlines agree everywhere.
        live = self._live()
        now = max(e._clock_us for e in live)
        for e in live:
            e._clock_us = max(e._clock_us, now)
        self._prune_prestaged()
        if self.migrate:
            self._steal()
        if self.steal_queued:
            self._steal_queued()
        return progressed or bool(self.pending)

    def run_until_drained(self, max_steps: int = 10_000) -> int:
        steps = 0
        while self.pending or any(self._busy(e) for e in self.engines):
            if steps >= max_steps:
                # Livelock detection: silently returning here used to
                # hand callers a half-drained cluster that looked done.
                stuck = sorted(
                    r.rid for e in self.engines
                    for r in list(e.queue) + list(e.active)
                    + list(e.preempted)
                    if e.alive) + sorted(r.rid for _, r in self.pending)
                raise RuntimeError(
                    f"run_until_drained: {len(stuck)} request(s) still "
                    f"outstanding after max_steps={max_steps} (rids "
                    f"{stuck[:16]}{'…' if len(stuck) > 16 else ''}) — "
                    f"the cluster is livelocked, or max_steps is too "
                    f"small for this workload")
            self.step()
            steps += 1
        for e in self._live():
            if e.fault_mode in ("async", "fused") and not self._busy(e):
                # Settle transfers still riding the channels (same rule
                # as ServingEngine.run_until_drained).  The reference
                # settles async engines only, which leaves a fused
                # engine's last transfers out of its hidden/exposed split.
                e._clock_us = max(e._clock_us, e.dma.busy_until())
                e._drain_prefetches()
        return steps

    # ------------------------------------------------------ crash recovery

    def _crash(self, idx: int) -> None:
        """Kill engine ``idx`` and recover its workload (DESIGN.md §12).

        Its device state (pools, staging, in-flight DMA) is gone by
        definition.  What survives is host-side, per protection domain:

        * **Preempted (and held) requests** are pure host-side bundles —
          Request + decode state + saved tokens, payloads in the shared
          store.  Each migrates to the least-loaded survivor through the
          existing export → ``migrate_seq`` → import path and resumes
          with **zero re-prefill**, byte-identical tokens.
        * **In-flight and queued requests** lose their device KV:
          they re-dispatch from the prompt (cleared outputs) — the
          deterministic decoder replays the same tokens.
        * **Pre-staged queued requests** (DESIGN.md §14): the pre-stage
          died with the victim's staging buffers.  The tracking entry is
          dropped *before* the requeue — with the victim-side pages
          written off as cancelled, never refunded into live lanes — so
          each such request re-enters ``pending`` exactly once and
          pre-stages afresh at whichever survivor dispatch picks (no
          double-charge of DMA lane time, no double dispatch).
        * The dead domain's remaining host frames are reclaimed whole
          (:meth:`SharedHostTier.reclaim_domain`); prefix-domain frames
          belong to a different domain by construction and survive.
        """
        victim = self.engines[idx]
        if not victim.alive:
            return
        victim.alive = False
        self.stats.crashes += 1
        live = self._live()
        if not live:
            raise RuntimeError(
                f"engine {victim.engine_id} crashed with no survivor — "
                f"the cluster cannot recover")
        # Write off pre-stages targeting the victim: its lanes are dead,
        # so the "refund" is bookkeeping only (counted on the victim,
        # not credited to any live lane) — the rid's entry must be gone
        # before the requeue below re-dispatches it.
        for rid, pidx in list(self._prestaged.items()):
            if pidx == idx:
                del self._prestaged[rid]
                victim.cancel_prestage(rid)
                self.stats.prestage_cancels += 1
        victim.preempted.extend(victim._held)
        victim._held.clear()
        if self.tier is not None:
            for r in list(victim.preempted):
                bundle = victim.export_preempted(r.rid)
                dst = min(live, key=lambda e: (self._load(e), e.engine_id))
                self.tier.migrate_seq(r.rid, dst.engine_id)
                dst.import_preempted(bundle)
                self._owner[r.rid] = self.engines.index(dst)
                self.stats.recovered_bundles += 1
        requeue = list(victim.active) + list(victim.preempted) \
            + list(victim.queue)
        victim.active.clear()
        victim.preempted.clear()
        victim.queue.clear()
        victim.states.clear()
        victim._saved_tokens.clear()
        for r in requeue:
            r.out.clear()
            r.done = False
            self._owner.pop(r.rid, None)
            self.pending.append((next(self._arrival), r))
            self.stats.recovered_requeued += 1
        if self.tier is not None:
            self.tier.reclaim_domain(victim.engine_id)

    # --------------------------------------------------------- work stealing

    def _src_blocked(self, src: ServingEngine, pages_needed: int) -> bool:
        """Can ``src`` NOT resume this request itself right now?  Only
        then is stealing worth it — otherwise the local resume is
        strictly cheaper (no lease moves, warm prefetch state) and
        stealing would just ping-pong the request."""
        if len(src.active) >= src.max_batch:
            return True
        return src._free_pages_total() < \
            pages_needed + len(src.active) + 2

    def _dst_fits(self, dst: ServingEngine, pages_needed: int) -> bool:
        if len(dst.active) + len(dst.queue) + len(dst.preempted) \
                >= dst.max_batch:
            return False
        return dst._free_pages_total() >= \
            pages_needed + len(dst.active) + 2

    def _steal(self) -> None:
        """At most one migration per router step (keeps the schedule
        deterministic and easy to reason about; pressure that persists
        steals again next step)."""
        dsts = sorted(self._live(),
                      key=lambda e: (self._load(e), e.engine_id))
        for dst in dsts:
            for src in sorted(self._live(),
                              key=lambda e: (-self._load(e),
                                             e.engine_id)):
                if src is dst or not src.preempted:
                    continue
                for cand in src._resume_candidates():
                    pages = src.cache.pages_needed(
                        src._saved_tokens[cand.rid])
                    if not self._src_blocked(src, pages):
                        continue
                    if not self._dst_fits(dst, pages):
                        continue
                    self._migrate(cand.rid, src, dst)
                    self.stats.steal_rounds += 1
                    return

    def _steal_queued(self) -> None:
        """Re-dispatch at most one *queued, never-admitted* request per
        step (DESIGN.md §14).  Deterministic rule: the cheapest live
        engine takes the most urgent non-pinned queued request — rank
        ``(-priority, deadline, rid)``, rid breaking ties — of the
        costliest engine, and only when the source remains strictly
        costlier than the destination plus the request's own cost
        (hysteresis: a moved request can never bounce straight back).
        The request's pre-stage, if any, is cancelled at the source
        (lane-time refund) and restarted at the thief."""
        live = self._live()
        if len(live) < 2:
            return
        dst = min(live, key=lambda e: (self._load(e), e.engine_id))
        for src in sorted(live, key=lambda e: (-self._load(e),
                                               e.engine_id)):
            if src is dst:
                continue
            cands = [r for r in src.queue if r.rid not in self._pinned]
            if not cands:
                continue
            cand = min(cands, key=lambda r: (
                -r.priority,
                r.deadline_us if r.deadline_us is not None
                else float("inf"),
                r.rid))
            if self._load(src) <= self._load(dst) \
                    + self._request_cost(cand, dst):
                continue
            src.queue.remove(cand)
            self._cancel_prestage(cand.rid)
            dst_idx = self.engines.index(dst)
            self._owner[cand.rid] = dst_idx
            dst.submit(cand)
            self.stats.queued_steals += 1
            self.stats.dispatched[dst_idx] = \
                self.stats.dispatched.get(dst_idx, 0) + 1
            self._prestage_to(cand, dst_idx)
            return

    def _migrate(self, rid: int, src: ServingEngine,
                 dst: ServingEngine) -> None:
        bundle = src.export_preempted(rid)
        assert bundle is not None
        moved = self.tier.migrate_seq(rid, dst.engine_id)
        dst.import_preempted(bundle)
        self._owner[rid] = self.engines.index(dst)
        self.stats.migrations += 1
        self.stats.migrated_pages += moved
