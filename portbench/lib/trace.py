"""A ``torch.profiler`` trace of a slice of the window, reduced to what the
per-layer metrics and the ledger's breakdown read.

The slice is bracketed by ``torch.cuda.synchronize()``; its host length is
``window_s``.  ``busy_s`` is the union of the device intervals in it
(kernels, copies and sets: anything the card ran).  Kernel time by name is
the sum of each device event's own interval.  Idle gaps are the spaces
between busy intervals, labelled by the innermost host operation running
at their midpoint ("host code" where none was).
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

TOP = 10
LABELLED_GAPS = 2000


class Slice:
    """Start with :meth:`start`, end with :meth:`stop`; then read."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def reduce(self) -> None:
        """Read the events once the window has closed (slow: host work)."""
        from torch.autograd import DeviceType
        for ev in self.prof.events():
            tr = ev.time_range
            item = (tr.start * 1e-6, tr.end * 1e-6, ev.name)
            if ev.device_type == DeviceType.CUDA:
                self.device.append(item)
            elif ev.device_type == DeviceType.CPU:
                self.host.append(item)
        self.prof = None
        self.device.sort()
        self.host.sort()

    def busy_s(self) -> float:
        busy, end = 0.0, None
        for s, e, _ in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def kernel_s(self, substrings) -> float:
        return sum(e - s for s, e, n in self.device
                   if any(k in n for k in substrings))

    def top_ops(self) -> List[List]:
        by: Dict[str, float] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:120], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        gaps = []
        end = None
        for s, e, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        by: Dict[str, float] = {}
        for length, a, b in gaps[:LABELLED_GAPS]:
            label = self._label((a + b) / 2, starts)
            by[label] = by.get(label, 0.0) + length
        return [[n[:120], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def _label(self, t: float, starts: List[float]) -> str:
        best: Optional[Tuple[float, str]] = None
        i = bisect.bisect_right(starts, t)
        # Host events are nested; scan back over those that began before t.
        for s, e, n in reversed(self.host[max(0, i - 400):i]):
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, n)
        return best[1] if best else "host code"
