"""Host memory tier under the Mosaic pool: evicted KV page payloads.

Counterpart of the reference's ``HostPageStore`` (``serving/host_tier.py``).
Payloads are keyed by **logical** identity ``(seq, shard, vpn)``, not by
physical page: eviction frees the physical page, and a resumed sequence is
re-mapped to whatever frames CoCoA hands out; the fault-in path looks the
payload up by owner, scatters it to the page's new physical location and
drops the host copy.

Two kinds of tenant share the store, as in the reference:

* **Swapped requests** (``seq`` = a live request id >= 0): preemption parks
  their resident pages; resume + fault-in pops them back.
* **Cached prefixes** (``seq`` = a negative owner id minted by
  :class:`PrefixIndex`): cold shared prompt prefixes keyed by chained
  content hash.  They are read with :meth:`HostPageStore.peek`, never
  popped by fault-in, so any number of requests can reuse one parked
  prefix, and ``drop_seq`` of a finished request can never evict them.

Payloads are CPU torch tensors (numpy has no bfloat16): the engine's
eviction and parking gathers copy them off the card (``.cpu()``) and its
fault-in scatter copies them back (``.to(device)``) — the PCIe transfers of
demand paging.  :class:`PrefixPage` and :class:`PrefixIndex` are copies of
the reference's with their logic unchanged; only the payload type differs.
The disk spill tier (``SpillStore``) comes with the cluster slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
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
            "peak_pages": 0, "cached_pages": 0, "reused_pages": 0,
            "promoted_pages": 0,
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
        """Pages owned by live requests (seq ≥ 0) — excludes cached
        prefixes, which deliberately outlive their source requests."""
        return sum(1 for k in self._pages if k[0] >= 0)

    # ------------------------------------------------------------- movement

    def put(self, seq: int, shard: int, vpn: int,
            k_page: torch.Tensor, v_page: torch.Tensor, *,
            kind: str = "swap") -> None:
        """Park one page's payload (device→host already gathered).

        ``kind="swap"`` counts toward the preemption traffic stats;
        ``kind="prefix"`` is a :class:`PrefixIndex` insertion;
        ``kind="reuse"`` a per-request copy of a cached prefix page
        registered at cache-hit admission (no bus traffic: the transfer is
        accounted by the admission prefetch or the first fault);
        ``kind="promote"`` a page returning from a spill tier."""
        assert kind in ("swap", "prefix", "reuse", "promote"), kind
        self._pages[(seq, shard, vpn)] = (k_page, v_page)
        key = {"swap": "swapped_out_pages", "prefix": "cached_pages",
               "reuse": "reused_pages", "promote": "promoted_pages"}[kind]
        self.stats[key] += 1
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
        """Read a payload without dropping it (prefetch staging and
        prefix-cache reads: the host copy stays authoritative until the
        page is scattered into the pool)."""
        return self._pages[(seq, shard, vpn)]

    def discard(self, seq: int, shard: int, vpn: int) -> bool:
        """Drop one payload without transfer accounting (index eviction)."""
        return self._pages.pop((seq, shard, vpn), None) is not None

    def note_swap_out(self) -> None:
        """One whole-request preemption (for the swap counts)."""
        self.stats["swap_out_requests"] += 1

    def note_swap_in(self) -> None:
        """One whole-request resume."""
        self.stats["swap_in_requests"] += 1

    def drop_seq(self, seq: int) -> int:
        """Discard a sequence's parked pages (request cancelled/finished).

        Only touches keys owned by ``seq`` itself: prefix-cache pages live
        under negative :class:`PrefixIndex` owner ids."""
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


# ---------------------------------------------------------------- prefixes


@dataclasses.dataclass
class PrefixPage:
    """One cached prompt page: the payload key + chain bookkeeping."""

    chain_hash: bytes               # H(parent_hash ‖ page tokens)
    page_index: int                 # global page number within the prompt
    owner: int                      # negative HostPageStore namespace
    shard: int
    vpn: int                        # local vpn in ``shard``
    parent: Optional[bytes]
    tick: int                       # LRU clock of the last lookup/insert
    hits: int = 0


class PrefixIndex:
    """Content-hash index over cold shared prompt prefixes.

    Prompts are hashed per *base page* with a chained hash — page ``i``'s
    key is ``H(key[i-1] ‖ tokens[i·ptok:(i+1)·ptok])`` — so a key match
    implies the **whole prefix up to and including that page** matches,
    and divergent prompts share index entries exactly up to their common
    page-aligned prefix.  Payloads (the pages' KV, bitwise as prefill
    wrote them) live in the :class:`HostPageStore` under per-page negative
    owner ids; the index maps hash → payload key.

    Invariant: the set of cached hashes is *prefix-closed* — a page is
    only inserted when its parent is present, and eviction removes a page
    together with all of its descendants — so the longest cached prefix
    of a prompt is found by walking its chain until the first miss.

    Eviction is LRU over chains: lookups and insertions touch every page
    of the matched chain with one tick, so a parent's tick is always ≥
    its children's, and the least-recently-used *childless* page is the
    tail of the stalest chain.  ``capacity_pages`` bounds host DRAM spent
    on cold prefixes.
    """

    def __init__(self, store: HostPageStore, page_tokens: int,
                 capacity_pages: int = 4096, *,
                 owner_start: int = -1, owner_step: int = -1) -> None:
        """``owner_start``/``owner_step`` namespace the negative owner
        ids this index mints, so that several indexes sharing one store
        use disjoint arithmetic progressions and never collide."""
        assert page_tokens >= 1 and capacity_pages >= 1
        assert owner_start < 0 and owner_step < 0
        self.store = store
        self.page_tokens = page_tokens
        self.capacity_pages = capacity_pages
        self._pages: Dict[bytes, PrefixPage] = {}
        self._children: Dict[bytes, set] = {}
        self._tick = 0
        self._next_owner = owner_start
        self._owner_step = owner_step
        self.stats = {"lookups": 0, "hit_pages": 0, "parked_pages": 0,
                      "evicted_pages": 0, "reused_tokens": 0}

    def __len__(self) -> int:
        return len(self._pages)

    # ------------------------------------------------------------- hashing

    def chain_hashes(self, tokens: np.ndarray) -> List[bytes]:
        """Chained content hash of every *full* page of ``tokens``."""
        ptok = self.page_tokens
        toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
        out: List[bytes] = []
        h = b"mosaic-prefix-v1"
        for p in range(len(toks) // ptok):
            page = toks[p * ptok:(p + 1) * ptok]
            h = hashlib.blake2b(h + page.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    # ------------------------------------------------------------- lookup

    def match(self, tokens: np.ndarray) -> Tuple[int, List[PrefixPage]]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(n_pages, pages)`` and touches the matched chain's LRU
        tick.  ``n_pages`` may cover the whole prompt; callers that need
        a non-empty suffix (the engine always prefills ≥ 1 real token)
        cap it themselves.
        """
        self.stats["lookups"] += 1
        self._tick += 1
        pages: List[PrefixPage] = []
        for h in self.chain_hashes(tokens):
            page = self._pages.get(h)
            if page is None:
                break
            page.tick = self._tick
            page.hits += 1
            pages.append(page)
        self.stats["hit_pages"] += len(pages)
        return len(pages), pages

    def peek_match(self, tokens: np.ndarray) -> Tuple[int, List[PrefixPage]]:
        """Read-only probe of :meth:`match`: the same longest-cached-
        prefix walk, but it touches *nothing* — no LRU tick, no per-page
        hit counters, no lookup stats."""
        pages: List[PrefixPage] = []
        for h in self.chain_hashes(tokens):
            page = self._pages.get(h)
            if page is None:
                break
            pages.append(page)
        return len(pages), pages

    def payload(self, page: PrefixPage) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.store.peek(page.owner, page.shard, page.vpn)

    def missing_from(self, hashes: Sequence[bytes]) -> int:
        """First index of ``hashes`` not cached (prefix-closure: every
        later index is missing too) — the pages a parker must supply."""
        for i, h in enumerate(hashes):
            if h not in self._pages:
                return i
        return len(hashes)

    # ------------------------------------------------------------- insert

    def park(self, chain_hash: bytes, parent: Optional[bytes],
             page_index: int, shard: int, vpn: int,
             k_page: torch.Tensor, v_page: torch.Tensor) -> PrefixPage:
        """Insert one page (its chain prefix must already be cached)."""
        assert parent is None or parent in self._pages, \
            "prefix chains must be parked root-first"
        if chain_hash in self._pages:           # concurrent duplicate park
            return self._pages[chain_hash]
        # Never evict the chain being extended (tiny-capacity edge: the
        # freshly-parked parent is childless until this insert lands).
        protect = set()
        anc = parent
        while anc is not None:
            protect.add(anc)
            anc = self._pages[anc].parent
        self._evict_to(self.capacity_pages - 1, protect=frozenset(protect))
        self._tick += 1
        page = PrefixPage(chain_hash=chain_hash, page_index=page_index,
                          owner=self._next_owner, shard=shard, vpn=vpn,
                          parent=parent, tick=self._tick)
        self._next_owner += self._owner_step
        self._pages[chain_hash] = page
        if parent is not None:
            self._children.setdefault(parent, set()).add(chain_hash)
        self.store.put(page.owner, shard, vpn, k_page, v_page,
                       kind="prefix")
        self.stats["parked_pages"] += 1
        return page

    # ------------------------------------------------------------- evict

    def _evict_to(self, capacity: int,
                  protect: frozenset = frozenset()) -> None:
        """LRU-evict childless pages until ≤ ``capacity`` remain
        (``protect``: hashes exempt — the chain an insert is extending)."""
        while len(self._pages) > capacity:
            victim = min(
                (p for p in self._pages.values()
                 if not self._children.get(p.chain_hash)
                 and p.chain_hash not in protect),
                key=lambda p: (p.tick, p.page_index), default=None)
            if victim is None:      # only protected chains remain
                break
            self._evict_page(victim)

    def _evict_page(self, page: PrefixPage) -> None:
        # Descendants first (recursion keeps the prefix-closure invariant
        # even if called on an inner page directly).
        for child in list(self._children.get(page.chain_hash, ())):
            if child in self._pages:
                self._evict_page(self._pages[child])
        self._children.pop(page.chain_hash, None)
        if page.parent is not None and page.parent in self._children:
            self._children[page.parent].discard(page.chain_hash)
        del self._pages[page.chain_hash]
        self.store.discard(page.owner, page.shard, page.vpn)
        self.stats["evicted_pages"] += 1

    def evict_owner_pages(self, owners: Iterable[int]) -> int:
        """Evict every cached page whose payload owner id is in ``owners``
        (descendants included — prefix-closure survives), so index and
        store can never disagree about what is cached.  Returns pages
        evicted."""
        owners = set(owners)
        before = self.stats["evicted_pages"]
        for page in [p for p in self._pages.values() if p.owner in owners]:
            if page.chain_hash in self._pages:      # not already cascaded
                self._evict_page(page)
        return self.stats["evicted_pages"] - before

    def drop_all(self) -> int:
        n = len(self._pages)
        self._evict_to(0)
        return n
