"""Host memory tier under the Mosaic pool: evicted KV page payloads.

Counterpart of the reference's ``HostPageStore`` (``serving/host_tier.py``).
Payloads are keyed by **logical** identity ``(seq, shard, vpn)``, not by
physical page: eviction frees the physical page, and a resumed sequence is
re-mapped to whatever frames CoCoA hands out; the fault-in path looks the
payload up by owner, scatters it to the page's new physical location and
drops the host copy.

Payloads are CPU torch tensors (numpy has no bfloat16): the engine's
eviction gather copies them off the card (``.cpu()``) and its fault-in
scatter copies them back (``.to(device)``) — the PCIe transfers of demand
paging.  The prefix index and the disk spill tier come in a later slice.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

Key = Tuple[int, int, int]          # (seq, shard, local vpn)


class HostPageStore:
    """Host-DRAM store of KV base-page payloads.

    Each entry is one base page of one sub-pool: a pair of CPU tensors
    ``(k_page, v_page)`` shaped ``[L, page_tokens, kv_heads, head_dim]``.
    """

    def __init__(self) -> None:
        self._pages: Dict[Key, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.stats = {
            "swapped_out_pages": 0, "swapped_in_pages": 0,
            "swap_out_requests": 0, "swap_in_requests": 0,
            "peak_pages": 0,
        }

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self._pages)

    def has(self, seq: int, shard: int, vpn: int) -> bool:
        return (seq, shard, vpn) in self._pages

    def seq_pages(self, seq: int) -> List[Key]:
        return sorted(k for k in self._pages if k[0] == seq)

    def nbytes(self) -> int:
        return sum(k.nbytes + v.nbytes for k, v in self._pages.values())

    def request_pages(self) -> int:
        """Pages owned by live requests (seq ≥ 0)."""
        return sum(1 for k in self._pages if k[0] >= 0)

    # ------------------------------------------------------------- movement

    def put(self, seq: int, shard: int, vpn: int,
            k_page: torch.Tensor, v_page: torch.Tensor) -> None:
        """Park one page's payload (device→host already gathered)."""
        self._pages[(seq, shard, vpn)] = (k_page, v_page)
        self.stats["swapped_out_pages"] += 1
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       len(self._pages))

    def pop(self, seq: int, shard: int, vpn: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Retrieve and drop one payload for fault-in (host→device)."""
        kv = self._pages.pop((seq, shard, vpn))
        self.stats["swapped_in_pages"] += 1
        return kv

    def peek(self, seq: int, shard: int, vpn: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Read a payload without dropping it."""
        return self._pages[(seq, shard, vpn)]

    def note_swap_out(self) -> None:
        """One whole-request preemption (for the swap counts)."""
        self.stats["swap_out_requests"] += 1

    def note_swap_in(self) -> None:
        """One whole-request resume."""
        self.stats["swap_in_requests"] += 1

    def drop_seq(self, seq: int) -> int:
        """Discard a sequence's parked pages (request cancelled/finished)."""
        keys = [k for k in self._pages if k[0] == seq]
        for k in keys:
            del self._pages[k]
        return len(keys)

    # -------------------------------------------------------- tier hooks
    # A standalone engine's private store has no disk tier underneath;
    # these mirror the reference's shared-tier surface so the cluster
    # slice can hand the engine another store without the engine branching.

    def park_allowed(self) -> bool:
        """Back-pressure probe: an unbounded store always accepts parks."""
        return True

    def ensure_resident(self, keys: Iterable[Key],
                        now_us: Optional[float] = None) -> float:
        """Promote ``keys`` from the spill tier; returns the stall µs
        (always 0 here — nothing is ever spilled from a private store)."""
        return 0.0

    def pump(self, now_us: float) -> None:
        """Advance the tier's write-back pipeline to ``now_us`` (no-op)."""

    def take_lost(self, seq: int) -> bool:
        """Whether ``seq``'s pages were destroyed by a spill quarantine
        (always False here — a private store has no disk underneath)."""
        return False
