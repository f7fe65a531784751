"""Phase spans and per-step counters of the serving engine.

A span times a block of the engine with ``time.perf_counter()`` and adds
its seconds to the open step record and, where ``stat`` names a field of
``stats`` (the engine's :class:`EngineStats`), to that field.  While
``torch.profiler`` records, a span also opens a host range of its name on
the profiler's timeline, the clock the device events are on, so a trace
names the engine phase the host was in while the card idled.  The range
is ``_RecordFunctionFast``, a host event only: ``record_function`` also
emits a device-side annotation over the kernels launched inside it, which
a trace would read as device work.

``ServingEngine.step`` holds one :func:`step_record` per call, early
returns included; on exit the record joins a bounded log: the engine's
``engine_id``, each span's inclusive seconds, the seconds of the spans
directly under ``serve.step`` (depth 1), and the step's counters
(:func:`count`, and the managers' OutOfMemory compaction passes as
deltas).  :func:`window` sums the last ``n`` records.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional

import torch

LOG_STEPS = 4096
_log: Deque[dict] = deque(maxlen=LOG_STEPS)
_open: Optional["_Record"] = None      # the step in progress


class _Record:
    __slots__ = ("engine_id", "spans", "depth1", "counters", "depth")

    def __init__(self, engine_id: int):
        self.engine_id = engine_id
        self.spans: Dict[str, float] = {}
        self.depth1: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.depth = -1         # serve.step opens at depth 0


def _profiler_range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


class span:
    """``with span("serve.decode", "decode_s", engine.stats) as sp:``;
    ``sp.seconds`` holds the block's seconds after it."""

    __slots__ = ("name", "stat", "stats", "seconds", "_t0", "_rec",
                 "_depth", "_range")

    def __init__(self, name: str, stat: Optional[str] = None, stats=None):
        self.name, self.stat, self.stats = name, stat, stats
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        rec = self._rec = _open
        if rec is not None:
            rec.depth += 1
            self._depth = rec.depth
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        s = self.seconds = time.perf_counter() - self._t0
        if self.stat is not None:
            setattr(self.stats, self.stat, getattr(self.stats, self.stat) + s)
        rec = self._rec
        if rec is not None:
            rec.depth = self._depth - 1
            rec.spans[self.name] = rec.spans.get(self.name, 0.0) + s
            if self._depth == 1:
                rec.depth1[self.name] = rec.depth1.get(self.name, 0.0) + s
        if self._range is not None:
            self._range.__exit__(*exc)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the open step's counter ``name`` (no step: nothing)."""
    rec = _open
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


class step_record:
    """One engine step's record; ``cache`` (a ``ShardedKVCache``) gives the
    managers' OutOfMemory compaction passes and refusals as deltas."""

    __slots__ = ("rec", "cache", "_oom", "_prev")

    def __init__(self, engine_id: int, cache):
        self.rec, self.cache = _Record(engine_id), cache

    def __enter__(self) -> None:
        global _open
        self._oom = self.cache.oom_counts()
        self._prev, _open = _open, self.rec

    def __exit__(self, *exc) -> None:
        global _open
        _open = self._prev
        rec = self.rec
        for name, now, then in zip(("oom_compactions", "oom_refusals"),
                                   self.cache.oom_counts(), self._oom):
            rec.counters[name] = now - then
        _log.append({"engine_id": rec.engine_id, "spans": rec.spans,
                     "depth1": rec.depth1, "counters": rec.counters})


def window(n: int) -> Optional[dict]:
    """Totals over the last ``n`` step records: ``spans`` and ``depth1``
    (seconds), ``counters``, ``records_with`` (per counter, the records
    that carry it) and ``steps`` = n; None when fewer are held."""
    if n <= 0 or n > len(_log):
        return None
    out = {"steps": n, "spans": {}, "depth1": {}, "counters": {},
           "records_with": {}}
    for rec in list(_log)[-n:]:
        for key in ("spans", "depth1", "counters"):
            tot = out[key]
            for name, v in rec[key].items():
                tot[name] = tot.get(name, 0) + v
        for name in rec["counters"]:
            out["records_with"][name] = out["records_with"].get(name, 0) + 1
    return out
