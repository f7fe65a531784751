"""Host↔card page transfers through a bounded, page-locked ring.

Demand paging moves base pages between the card's layer-stacked pools and
the host store: a preemption or a park gathers a request's resident pages
off the card, a fault-in lands host payloads in the pool.  Moved as one
batch, a transfer stages every page of the request on the card at once
(the longest prompt of a 64-token-page qwen2.5-3b pool is 123 pages, 290
MB) and copies from pageable host memory, which the CUDA runtime stages
once more through its own buffers.

:class:`PageRing` moves the pages in chunks of at most ``chunk`` pages
(the engine's one Mosaic large-page frame) through two page-locked host
slots of one chunk per pool, allocated once:

* card → host (:meth:`PageRing.gather`): chunk i is gathered on the card
  (``page_gather``) and copied without blocking into slot i % 2; the host
  copies slot i % 2 into the transfer's pageable payload tensors while
  chunk i + 1 gathers and copies;
* host → card (:meth:`PageRing.scatter`): chunk i is packed into slot
  i % 2 while chunk i - 1 copies and lands (``page_scatter``, through the
  caller's ``land``).

Everything runs on the pools' current stream: the card holds one chunk of
staging a pool, taken from the caching allocator and handed back to it in
stream order, and an event a slot tells the host when the copy that reads
or writes the slot is done.  On the CPU the slots are plain tensors and
the same chunks run the kernels' plain versions.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops


class PageRing:
    """Two host slots of ``chunk`` pages for each of the ``pools`` (K and
    V; MLA's latent pools have their own widths)."""

    def __init__(self, pools: Sequence[torch.Tensor], chunk: int):
        if chunk < 1:
            raise ValueError(f"a chunk holds at least one page, got {chunk}")
        self.pools = tuple(pools)
        self.chunk = chunk
        dev = self.pools[0].device
        pin = dev.type == "cuda"
        self.slots = [[torch.empty(chunk * p[:, 0].numel(), dtype=p.dtype,
                                   pin_memory=pin) for _ in range(2)]
                      for p in self.pools]
        self.events = ([torch.cuda.Event() for _ in range(2)] if pin
                       else None)

    def chunks(self, n: int) -> List[Tuple[int, int]]:
        """(first, end) page of each chunk of an n-page transfer."""
        return [(lo, min(lo + self.chunk, n))
                for lo in range(0, n, self.chunk)]

    def _slot(self, p: int, s: int, n: int) -> torch.Tensor:
        """Slot ``s`` of pool ``p`` as [L, n, ...] (contiguous)."""
        pool = self.pools[p]
        return self.slots[p][s][:n * pool[:, 0].numel()].view(
            pool.shape[0], n, *pool.shape[2:])

    def _record(self, s: int) -> None:
        if self.events is not None:
            self.events[s].record(
                torch.cuda.current_stream(self.pools[0].device))

    def _wait(self, s: int) -> None:
        if self.events is not None:
            self.events[s].synchronize()

    def gather(self, idx: torch.Tensor
               ) -> Tuple[List[torch.Tensor], int]:
        """Pages ``idx`` (int32 on the pools' device) of every pool into
        new host tensors [L, n, ...]; returns them and the chunks moved."""
        n = idx.shape[0]
        out = [torch.empty((p.shape[0], n, *p.shape[2:]), dtype=p.dtype)
               for p in self.pools]
        chunks = self.chunks(n)

        def launch(i: int) -> None:
            lo, hi = chunks[i]
            for p, pool in enumerate(self.pools):
                pages = kops.page_gather(pool, idx[lo:hi])
                self._slot(p, i % 2, hi - lo).copy_(pages, non_blocking=True)
            self._record(i % 2)

        launch(0)
        for i, (lo, hi) in enumerate(chunks):
            if i + 1 < len(chunks):
                launch(i + 1)
            self._wait(i % 2)
            for p, o in enumerate(out):
                o[:, lo:hi] = self._slot(p, i % 2, hi - lo)
        return out, len(chunks)

    def scatter(self, idx: torch.Tensor,
                payloads: Sequence[Sequence[torch.Tensor]],
                land: Callable[..., None]) -> int:
        """Land ``payloads`` (per page, one host tensor [L, ...] a pool,
        in the pool's dtype) at pool pages ``idx``: ``land(idx_chunk, *device_chunks)`` writes
        each chunk into the pools.  Returns the chunks moved."""
        chunks = self.chunks(len(payloads))
        for i, (lo, hi) in enumerate(chunks):
            self._wait(i % 2)        # the copy that read this slot is done
            staged = []
            for p, pool in enumerate(self.pools):
                view = self._slot(p, i % 2, hi - lo)
                torch.stack([pl[p] for pl in payloads[lo:hi]], dim=1,
                            out=view)
                staged.append(torch.empty(view.shape, dtype=pool.dtype,
                                          device=pool.device)
                              .copy_(view, non_blocking=True))
            self._record(i % 2)
            land(idx[lo:hi], *staged)
            del staged               # back to the allocator in stream order
        return len(chunks)
