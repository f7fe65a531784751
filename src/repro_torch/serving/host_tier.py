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
eviction and parking gathers copy them off the card and its fault-in
scatter copies them back, a frame at a time through page-locked slots
(:mod:`repro_torch.serving.page_ring`) — the PCIe transfers of demand
paging.  :class:`PrefixPage` and :class:`PrefixIndex` are copies of
the reference's with their logic unchanged; only the payload type differs.

Below host DRAM sits the disk tier, :class:`SpillStore`: one file per
spilled host frame (all pages of one protection domain).  It is the
reference's, with one change the payload type forces: a tensor is packed
as its raw bytes (``t.contiguous().view(torch.uint8)``) beside its torch
dtype and shape, so a bfloat16 page comes back with the same dtype, shape
and bits.  The frame digest is the reference's (blake2b over the packed
bytes in page order), so the same payload gives the same digest in both
packages and an injected bit flip lands on the same byte.  The
spill/promote orchestration lives in
:class:`~repro_torch.serving.cluster.SharedHostTier`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

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


# ------------------------------------------------------------------- disk


class SpillStore:
    """Disk tier under the host store: whole-frame spill files.

    One ``.npz`` file per spilled host frame, holding every page payload
    of that frame plus its keys and protection domain — so a frame comes
    back from disk exactly as it left, and the single-domain-per-frame
    invariant holds on disk *by construction* (a file cannot mix domains
    because a frame cannot).  Round-trips are byte-exact; the modeled
    disk latency/bandwidth lives in the orchestrating tier, not here.

    Integrity: every frame is written with a blake2b digest of its true
    payload bytes (stored both in the file and in the in-memory frame
    map), and :meth:`read_frame` re-hashes what it loaded before
    returning anything — a flipped bit anywhere in the payload raises
    :class:`~repro_torch.serving.faults.SpillCorruptionError` and the
    corrupted KV is **never decoded from**.  An optional
    :class:`~repro_torch.serving.faults.FaultInjector` injects read/write
    errors and on-disk bit flips at exactly these seams.

    ``root=None`` creates (lazily) and owns a temp directory, removed by
    :meth:`close`; a caller-supplied ``root`` is reused and kept.  A
    pre-existing ``root`` is swept of orphaned ``frame_*.npz`` files at
    construction — a crashed run's leftovers carry no in-memory frame
    map, so they could never be promoted and must not be misread by (or
    collide with) the next run's frame ids.  The store is a context
    manager: ``with SpillStore() as s: ...`` closes (and, when owned,
    removes) the directory on exit even if the run died mid-spill.
    """

    def __init__(self, root: Optional[str] = None, *,
                 injector=None) -> None:
        self.root = root
        self._owned = root is None
        self._dir: Optional[str] = None
        self.injector = injector
        # frame id → (path, keys in file order, domain, per-page
        # (k_dtype, k_shape, v_dtype, v_shape) — payloads are stored as
        # raw bytes so bfloat16 round-trips exactly — and the blake2b
        # digest of the true payload bytes)
        self._frames: Dict[int, Tuple[str, Tuple[Key, ...], Hashable,
                                      Tuple[tuple, ...], bytes]] = {}
        self.stats = {
            "frames_written": 0, "pages_written": 0, "bytes_written": 0,
            "frames_read": 0, "pages_read": 0, "bytes_read": 0,
            "frames_deleted": 0, "peak_frames": 0,
            "orphans_swept": 0, "frames_quarantined": 0,
            "checksum_failures": 0,
        }
        if root is not None and os.path.isdir(root):
            self._sweep_orphans(root)

    def _sweep_orphans(self, d: str) -> None:
        """Remove frame files a previous (crashed) run left behind: the
        in-memory frame map is empty at construction, so every existing
        ``frame_*.npz`` is unreachable and would only risk being misread
        under a recycled frame id."""
        for name in sorted(os.listdir(d)):
            if name.startswith("frame_") and name.endswith(".npz"):
                try:
                    os.remove(os.path.join(d, name))
                    self.stats["orphans_swept"] += 1
                except OSError:
                    pass        # already gone / unreadable: harmless

    def __enter__(self) -> "SpillStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _ensure_dir(self) -> str:
        if self._dir is None:
            if self.root is not None:
                os.makedirs(self.root, exist_ok=True)
                self._dir = self.root
            else:
                self._dir = tempfile.mkdtemp(prefix="mosaic-spill-")
        return self._dir

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self._frames)

    def has_frame(self, frame: int) -> bool:
        return frame in self._frames

    def frame_ids(self) -> List[int]:
        return sorted(self._frames)

    def frame_keys(self, frame: int) -> Tuple[Key, ...]:
        return self._frames[frame][1]

    @staticmethod
    def _pack(t: torch.Tensor) -> Tuple[np.ndarray, torch.dtype, tuple]:
        """Flatten to raw uint8 (npz cannot hold bfloat16): the tensor's
        bytes, its dtype and its shape."""
        c = t.detach().cpu().contiguous()
        return (c.reshape(-1).view(torch.uint8).numpy(), c.dtype,
                tuple(c.shape))

    @staticmethod
    def _unpack(raw: np.ndarray, dtype: torch.dtype,
                shape: tuple) -> torch.Tensor:
        return torch.from_numpy(raw).view(dtype).reshape(shape)

    # ------------------------------------------------------------- movement

    @staticmethod
    def _digest(packed: Sequence[np.ndarray]) -> bytes:
        """blake2b over a frame's packed payload bytes, in page order."""
        h = hashlib.blake2b(b"mosaic-spill-v1", digest_size=16)
        for a in packed:
            h.update(a.tobytes())
        return h.digest()

    def write_frame(self, frame: int, domain: Hashable,
                    pages: Sequence[Tuple[Key, Tuple[torch.Tensor,
                                                     torch.Tensor]]]) -> int:
        """Persist one whole frame; returns the payload byte count.

        May raise :class:`~repro_torch.serving.faults.SpillIOError`
        (injected disk failure) *before* any state mutates — a failed
        write leaves the store exactly as it was, so the tier can retry
        or cancel."""
        assert pages, "spilling an empty frame"
        assert frame not in self._frames, f"frame {frame} already on disk"
        if self.injector is not None:
            self.injector.disk_write_fault(frame)
        path = os.path.join(self._ensure_dir(), f"frame_{frame:08d}.npz")
        arrs: Dict[str, np.ndarray] = {
            "keys": np.asarray([k for k, _ in pages], np.int64),
            "domain": np.asarray(repr(domain)),
        }
        nbytes = 0
        meta = []
        packed: List[np.ndarray] = []
        for i, (_key, (kp, vp)) in enumerate(pages):
            arrs[f"k{i}"], kdt, ksh = self._pack(kp)
            arrs[f"v{i}"], vdt, vsh = self._pack(vp)
            packed.extend((arrs[f"k{i}"], arrs[f"v{i}"]))
            meta.append((kdt, ksh, vdt, vsh))
            nbytes += kp.nbytes + vp.nbytes
        arrs["dtypes"] = np.asarray([f"{m[0]}:{m[2]}" for m in meta])
        # The digest is of the TRUE bytes; injected corruption flips a
        # bit only in what lands on disk, so verification must catch it.
        digest = self._digest(packed)
        arrs["checksum"] = np.frombuffer(digest, np.uint8).copy()
        if self.injector is not None:
            bad = self.injector.corrupt_written(frame, arrs["k0"].tobytes())
            if bad is not None:
                arrs["k0"] = np.frombuffer(bad, np.uint8)
        np.savez(path, **arrs)
        self._frames[frame] = (path, tuple(k for k, _ in pages), domain,
                               tuple(meta), digest)
        self.stats["frames_written"] += 1
        self.stats["pages_written"] += len(pages)
        self.stats["bytes_written"] += nbytes
        self.stats["peak_frames"] = max(self.stats["peak_frames"],
                                        len(self._frames))
        return nbytes

    def read_frame(self, frame: int, expect_domain: Hashable = None
                   ) -> List[Tuple[Key, Tuple[torch.Tensor, torch.Tensor]]]:
        """Load a whole frame back (promote); file stays until deleted.

        Raises :class:`~repro_torch.serving.faults.SpillIOError` on an
        (injected) disk error and :class:`~repro_torch.serving.faults.
        SpillCorruptionError` when the loaded payload bytes fail
        checksum verification — in both cases **before** returning any
        payload, so corrupted or unreadable KV is never decoded from."""
        path, keys, domain, meta, digest = self._frames[frame]
        if self.injector is not None:
            self.injector.disk_read_fault(frame)
        if expect_domain is not None:
            assert domain == expect_domain, \
                f"frame {frame} spilled under {domain!r}, " \
                f"promoted under {expect_domain!r}"
        out: List[Tuple[Key, Tuple[torch.Tensor, torch.Tensor]]] = []
        nbytes = 0
        with np.load(path) as z:
            stored = tuple(tuple(int(x) for x in row) for row in z["keys"])
            assert stored == keys, f"frame {frame} file/index key mismatch"
            raw = [z[f"{kv}{i}"] for i in range(len(stored))
                   for kv in ("k", "v")]
            if self._digest(raw) != digest:
                from repro_torch.serving.faults import SpillCorruptionError
                self.stats["checksum_failures"] += 1
                raise SpillCorruptionError(frame)
            for i, key in enumerate(stored):
                kdt, ksh, vdt, vsh = meta[i]
                kp = self._unpack(raw[2 * i], kdt, ksh)
                vp = self._unpack(raw[2 * i + 1], vdt, vsh)
                nbytes += kp.nbytes + vp.nbytes
                out.append((key, (kp, vp)))
        self.stats["frames_read"] += 1
        self.stats["pages_read"] += len(out)
        self.stats["bytes_read"] += nbytes
        return out

    def delete_frame(self, frame: int) -> None:
        path = self._frames.pop(frame)[0]
        if os.path.exists(path):
            os.remove(path)
        self.stats["frames_deleted"] += 1

    def quarantine_frame(self, frame: int) -> None:
        """Drop a corrupted/unreadable frame without counting it as a
        normal delete: the file (if any) is removed so a bad payload can
        never be read again, and the frame id leaves the map so the
        tier can rebuild its contents from upstream truth."""
        path = self._frames.pop(frame)[0]
        try:
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            pass                # unreadable file may also be unlinkable
        self.stats["frames_quarantined"] += 1

    def close(self) -> None:
        """Drop every file; removes the temp directory when owned."""
        for f in list(self._frames):
            self.delete_frame(f)
        if self._owned and self._dir is not None \
                and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)
        self._dir = None


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
