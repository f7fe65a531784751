"""Deterministic failure injection for the serving stack (DESIGN.md §12).

Mosaic's single-domain-per-frame invariant is what makes recovery
*cheap*: a host frame is owned by exactly one protection domain, so a
dead engine's frames can be reclaimed (or re-leased to a survivor)
whole, with no base-page migration, and the shared prefix-cache frames
— a different domain by construction — survive the owner's death
untouched.  This module supplies the failure model that exercises those
properties end-to-end:

* :class:`FaultPlan` — a declarative, seeded schedule of faults:
  engine crashes at specific router steps, transient/permanent disk
  read and write errors, spill-frame corruption (bit flips written to
  disk), and DMA lane stalls.  Same plan + same seed ⇒ the same faults
  fire at the same points in any run, so recovery benches and tests are
  exactly reproducible.
* :class:`FaultInjector` — the runtime half: hook methods called from
  the injection sites (:class:`~repro_torch.serving.router.RequestRouter`
  for crashes, :class:`~repro_torch.serving.host_tier.SpillStore` for disk
  I/O and corruption, :class:`~repro_torch.serving.dma.AsyncDMAEngine` for
  lane stalls).  Every injected fault is counted and logged.  A
  component given ``injector=None`` (the default everywhere) pays zero
  overhead — the hooks are never consulted.
* :class:`SpillIOError` / :class:`SpillCorruptionError` — the error
  vocabulary the recovery machinery speaks: transient I/O errors are
  retried with exponential backoff charged to the modeled clock
  (:class:`~repro_torch.serving.cluster.SharedHostTier`), permanent errors
  and checksum mismatches quarantine the frame and trigger rebuild
  (prefix frames re-derived through their index, request frames
  restarted from the prompt), and a rising error rate degrades the
  tier to the hard-cap (``spill=False``) path without dropping
  requests.

The injector is *process-wide* state shared by every component of one
cluster, so a plan reads like an incident script: "crash engine 0 at
step 6; every third disk read fails once; frame 2's file is corrupted
on disk".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class SpillIOError(IOError):
    """A disk read/write of a spill frame failed.

    ``transient=True`` models a retryable error (bus hiccup, throttled
    device): the tier retries with exponential backoff charged to the
    modeled clock.  ``transient=False`` is permanent (bad sector, file
    vanished): the frame is quarantined and rebuilt."""

    def __init__(self, frame: int, op: str, *, transient: bool) -> None:
        self.frame = frame
        self.op = op
        self.transient = transient
        kind = "transient" if transient else "permanent"
        super().__init__(f"{kind} disk {op} error on spill frame {frame}")


class SpillCorruptionError(ValueError):
    """A spill frame's payload bytes failed checksum verification.

    Raised by :meth:`SpillStore.read_frame` *before* any payload is
    returned — corrupted KV is never decoded from.  The tier
    quarantines the frame and rebuilds its contents from upstream
    truth (the prefix index re-derives, requests re-prefill)."""

    def __init__(self, frame: int) -> None:
        self.frame = frame
        super().__init__(
            f"spill frame {frame} failed checksum verification "
            f"(on-disk corruption) — payload quarantined, not decoded")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative fault schedule (all fields default to "no
    faults", so a plan only states what it breaks).

    * ``engine_crashes`` — ``(router_step, engine_id)`` pairs: the
      engine dies at the *start* of that router step (its device state
      is lost; host-tier state survives per domain).
    * ``disk_read_error_rate`` / ``disk_write_error_rate`` — per-op
      probability of a *transient* :class:`SpillIOError` (drawn from
      the seeded RNG, so the same ops fail across runs).
    * ``permanent_read_frames`` — frames whose reads always fail
      permanently (bad sector).
    * ``corrupt_write_rate`` — per-frame probability that a spill
      write lands on disk with a flipped bit (the checksum recorded is
      of the *true* bytes, so verification must catch it).
    * ``corrupt_frames`` — frames corrupted unconditionally.
    * ``dma_stall_every`` / ``dma_stall_us`` — every Nth enqueued DMA
      job (per direction) is stalled by ``dma_stall_us`` extra µs on
      its lane (a throttled channel), 0 disables.
    """

    seed: int = 0
    engine_crashes: Tuple[Tuple[int, int], ...] = ()
    disk_read_error_rate: float = 0.0
    disk_write_error_rate: float = 0.0
    max_transient_failures: int = 2     # per frame+op: then reads succeed
    permanent_read_frames: Tuple[int, ...] = ()
    corrupt_write_rate: float = 0.0
    corrupt_frames: Tuple[int, ...] = ()
    dma_stall_every: int = 0
    dma_stall_us: float = 0.0


class FaultInjector:
    """Runtime fault oracle: components ask it whether to fail.

    Deterministic: decisions come from a ``numpy`` RNG seeded by the
    plan, advanced only by the hook calls themselves — identical call
    sequences (which deterministic engines produce) yield identical
    fault sequences.  Transient errors are bounded per ``(frame, op)``
    by ``max_transient_failures`` so retry loops provably terminate in
    tests while still exercising the backoff path.
    """

    def __init__(self, plan: Optional[FaultPlan] = None) -> None:
        self.plan = plan or FaultPlan()
        self._rng = np.random.default_rng(self.plan.seed)
        self._crashed: set = set()
        self._transients: Dict[Tuple[int, str], int] = {}
        self._dma_jobs = 0
        self.log: List[Tuple[str, tuple]] = []
        self.stats = {
            "engine_crashes": 0, "disk_read_errors": 0,
            "disk_write_errors": 0, "permanent_read_errors": 0,
            "corrupted_frames": 0, "dma_stalls": 0,
            "dma_stall_us": 0.0,
        }

    def _note(self, kind: str, *detail) -> None:
        self.log.append((kind, detail))

    # ------------------------------------------------------------- crashes

    def crashes_due(self, step: int) -> List[int]:
        """Engine ids scheduled to die at (or before) ``step`` that have
        not fired yet — the router calls this at each step start."""
        due = []
        for at, eng in self.plan.engine_crashes:
            if at <= step and (at, eng) not in self._crashed:
                self._crashed.add((at, eng))
                due.append(eng)
                self.stats["engine_crashes"] += 1
                self._note("engine_crash", step, eng)
        return due

    # ---------------------------------------------------------------- disk

    def _transient_ok(self, frame: int, op: str) -> bool:
        """True if this (frame, op) may still fail transiently."""
        n = self._transients.get((frame, op), 0)
        if n >= self.plan.max_transient_failures:
            return False
        self._transients[(frame, op)] = n + 1
        return True

    def disk_write_fault(self, frame: int) -> None:
        """Called before a spill-frame write; raises to fail it."""
        rate = self.plan.disk_write_error_rate
        if rate > 0.0 and self._rng.random() < rate \
                and self._transient_ok(frame, "write"):
            self.stats["disk_write_errors"] += 1
            self._note("disk_write_error", frame)
            raise SpillIOError(frame, "write", transient=True)

    def disk_read_fault(self, frame: int) -> None:
        """Called before a spill-frame read; raises to fail it."""
        if frame in self.plan.permanent_read_frames:
            self.stats["permanent_read_errors"] += 1
            self._note("disk_read_permanent", frame)
            raise SpillIOError(frame, "read", transient=False)
        rate = self.plan.disk_read_error_rate
        if rate > 0.0 and self._rng.random() < rate \
                and self._transient_ok(frame, "read"):
            self.stats["disk_read_errors"] += 1
            self._note("disk_read_error", frame)
            raise SpillIOError(frame, "read", transient=True)

    def corrupt_written(self, frame: int, blob: bytes) -> Optional[bytes]:
        """Maybe bit-flip a frame's payload bytes as they land on disk.

        Returns the corrupted copy, or None to write faithfully.  The
        flipped bit position is drawn from the seeded RNG, so the same
        byte breaks across runs."""
        hit = frame in self.plan.corrupt_frames
        if not hit and self.plan.corrupt_write_rate > 0.0:
            hit = self._rng.random() < self.plan.corrupt_write_rate
        if not hit or not blob:
            return None
        pos = int(self._rng.integers(0, len(blob)))
        bit = 1 << int(self._rng.integers(0, 8))
        out = bytearray(blob)
        out[pos] ^= bit
        self.stats["corrupted_frames"] += 1
        self._note("frame_corruption", frame, pos)
        return bytes(out)

    # ----------------------------------------------------------------- dma

    def dma_stall(self, kind: str, direction: str) -> float:
        """Extra µs to add to the job being enqueued (lane stall)."""
        every = self.plan.dma_stall_every
        if every <= 0 or self.plan.dma_stall_us <= 0.0:
            return 0.0
        self._dma_jobs += 1
        if self._dma_jobs % every:
            return 0.0
        self.stats["dma_stalls"] += 1
        self.stats["dma_stall_us"] += self.plan.dma_stall_us
        self._note("dma_stall", kind, direction)
        return self.plan.dma_stall_us
