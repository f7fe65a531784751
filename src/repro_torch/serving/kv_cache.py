"""ShardedKVCache: host-side bridge between Mosaic managers and the device.

Counterpart of the reference's ``serving/kv_cache.py``.  Pages of one sequence are spread over ``S``
sub-pools; global virtual frame ``f`` of a sequence lives in sub-pool
``f % S``, so frames never straddle shards and each sub-pool runs its own
CoCoA / coalescer / CAC instance.

Each step the cache packs the device-facing :class:`PageCtx` tensors:

  tables[B, S, mpps]   local page ids       (-1 holes)
  ntok  [B, S, mpps]   valid tokens per page
  wpage [B, S]         local page receiving this step's token (-1 if not
                       owned by that shard)
  wslot [B]            slot within the write page

plus, for dual-granularity attention, per-shard coalesced frame lists and
splintered page lists (``pack_dual``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PoolGeometry
from repro_torch.core import make_manager
from repro_torch.core.compaction import CopyOp
from repro_torch.core.pagepool import PoolConfig
from repro_torch.models.page_ops import PageCtx


class ShardedKVCache:
    def __init__(self, geometry: PoolGeometry, pages_per_shard: int,
                 n_shards: int, manager_kind: str = "mosaic", *,
                 link=None, page_bytes: int = 0):
        self.geo = geometry
        self.S = n_shards
        self.pages_per_shard = pages_per_shard
        self.mgrs = [
            make_manager(manager_kind, PoolConfig(
                num_pages=pages_per_shard,
                frame_pages=geometry.frame_pages,
                page_tokens=geometry.page_tokens,
                compact_threshold=geometry.compact_threshold,
            ), link=link, page_bytes=page_bytes) for _ in range(n_shards)
        ]
        self.seq_tokens: Dict[int, int] = {}

    # ---------------------------------------------------------------- alloc

    def _shard_of_frame(self, f: int) -> int:
        return f % self.S

    def allocate(self, seq: int, n_tokens: int) -> None:
        """En-masse allocation (prefill): frames striped across sub-pools."""
        ptok = self.geo.page_tokens
        ftok = self.geo.frame_pages * ptok
        start = self.seq_tokens.get(seq, 0)
        end = start + n_tokens
        self.seq_tokens[seq] = end
        t = start
        while t < end:
            frame = t // ftok
            take = min(end, (frame + 1) * ftok) - t
            self.mgrs[self._shard_of_frame(frame)].allocate_tokens(seq, take)
            t += take

    def append(self, seq: int, n_tokens: int = 1) -> None:
        """Decode growth: token-by-token, striped by frame."""
        ftok = self.geo.frame_pages * self.geo.page_tokens
        for _ in range(n_tokens):
            t = self.seq_tokens.get(seq, 0)
            frame = t // ftok
            self.mgrs[self._shard_of_frame(frame)].append_tokens(seq, 1)
            self.seq_tokens[seq] = t + 1

    def free(self, seq: int) -> None:
        for m in self.mgrs:
            if seq in m.tables:
                m.deallocate(seq)
        self.seq_tokens.pop(seq, None)

    def drain_copy_ops(self) -> List[Tuple[int, CopyOp]]:
        """[(shard, op), ...] for the page_compact kernel (per sub-pool)."""
        out = []
        for s, m in enumerate(self.mgrs):
            for op in m.drain_copy_ops():
                out.append((s, op))
        return out

    # ------------------------------------------------------- host tier

    def locate_page(self, gp: int) -> Tuple[int, int]:
        """Global page index → (shard, local vpn) under frame striping.

        The inverse of ``write_prefill_kv``'s vpn reconstruction: global
        frame ``f = gp // frame_pages`` lives on shard ``f % S`` as its
        ``f // S``-th local frame.  Deterministic per geometry, so the
        same prompt page lands at the same (shard, vpn) for every
        sequence — the property the prefix cache's content-hash keys
        rely on.
        """
        fp = self.geo.frame_pages
        f = gp // fp
        return f % self.S, (f // self.S) * fp + gp % fp

    def demote_prefix_pages(self, seq: int,
                            pages: Sequence[Tuple[int, int]]
                            ) -> List[Tuple[int, int, int]]:
        """Mark freshly-allocated pages of ``seq`` non-resident so the
        fault-in path restores them from cached-prefix host payloads.
        ``pages``: [(shard, local vpn)].  Returns [(shard, vpn, ppn)] in
        input order for admission-prefetch enqueueing."""
        out: List[Tuple[int, int, int]] = []
        by_shard: Dict[int, List[int]] = {}
        for s, vpn in pages:
            ppn = self.mgrs[s].tables[seq].ppn[vpn]
            by_shard.setdefault(s, []).append(ppn)
            out.append((s, vpn, ppn))
        for s, ppns in by_shard.items():
            self.mgrs[s].residency.demote(ppns)
        return out

    def mapped_pages(self, seq: int) -> List[Tuple[int, int, int]]:
        """All of ``seq``'s mapped pages as [(shard, local vpn, ppn)]."""
        out = []
        for s, m in enumerate(self.mgrs):
            if seq not in m.tables:
                continue
            table = m.tables[seq]
            for vpn in table.mapped_vpns():
                out.append((s, vpn, table.ppn[vpn]))
        return out

    def evict_pages(self, pages: Sequence[Tuple[int, int, int]]) -> int:
        """Account a device→host spill of [(shard, vpn, ppn)] pages."""
        by_shard: Dict[int, List[int]] = {}
        for s, _vpn, ppn in pages:
            by_shard.setdefault(s, []).append(ppn)
        return sum(self.mgrs[s].residency.evict(ppns)
                   for s, ppns in by_shard.items())

    def demote_host_backed(self, seq: int, host) -> int:
        """After a resume re-allocation: pages whose payload sits in the
        host store become non-resident so the next step faults them in."""
        n = 0
        for s, m in enumerate(self.mgrs):
            if seq not in m.tables:
                continue
            table = m.tables[seq]
            ppns = [table.ppn[vpn] for vpn in table.mapped_vpns()
                    if host.has(seq, s, vpn)]
            m.residency.demote(ppns)
            n += len(ppns)
        return n

    def host_backed_pages(self, seqs: Sequence[int], host
                          ) -> List[Tuple[int, int, int, int]]:
        """Mapped-but-non-resident pages of ``seqs`` whose payload sits in
        the host store, as [(seq, shard, vpn, ppn)] — the prefetchable
        set, carrying the owner so callers need no reverse-map lookup."""
        out: List[Tuple[int, int, int, int]] = []
        for s, m in enumerate(self.mgrs):
            for seq in seqs:
                if seq not in m.tables:
                    continue
                table = m.tables[seq]
                for vpn in table.mapped_vpns():
                    ppn = table.ppn[vpn]
                    if not m.residency.resident[ppn] \
                            and host.has(seq, s, vpn):
                        out.append((seq, s, vpn, ppn))
        return out

    def pages_needed(self, n_tokens: int) -> int:
        """Pages a fresh en-masse allocation of ``n_tokens`` consumes
        (whole frames, CoCoA's reservation granularity).  The cluster
        router's steal guard sizes a migration target with it without
        touching the destination pool."""
        ftok = self.geo.frame_pages * self.geo.page_tokens
        frames = (n_tokens + ftok - 1) // ftok
        return frames * self.geo.frame_pages

    def resident_page_count(self, seq: int) -> int:
        """HBM-resident pages mapped by ``seq`` (the eviction-cost term
        of the engine's cost-aware victim score)."""
        n = 0
        for m in self.mgrs:
            if seq not in m.tables:
                continue
            table = m.tables[seq]
            n += sum(1 for vpn in table.mapped_vpns()
                     if m.residency.resident[table.ppn[vpn]])
        return n

    def missing_pages(self, seqs: Sequence[int]
                      ) -> Dict[int, List[Tuple[int, int, int]]]:
        """touch(): per shard, the non-resident (ppn, owner, vpn) triples
        among the pages the given sequences' packed tables will read."""
        out: Dict[int, List[Tuple[int, int, int]]] = {}
        for s, m in enumerate(self.mgrs):
            ppns = []
            for seq in seqs:
                if seq in m.tables:
                    table = m.tables[seq]
                    ppns.extend(table.ppn[v] for v in table.mapped_vpns())
            missing = m.residency.touch(ppns)
            if missing:
                out[s] = [(p, *m.rmap[p]) for p in missing]
        return out

    # ---------------------------------------------------------------- pack

    def pack_ctx(self, seqs: Sequence[int], mpps: int, *,
                 device="cpu") -> PageCtx:
        """Build the PageCtx for one decode step over ``seqs`` on ``device``.

        Call *after* ``append`` for the step's token.  mpps = max pages per
        (sequence, shard).  Page ids are shard-local.
        """
        B, S = len(seqs), self.S
        ptok = self.geo.page_tokens
        tables = np.full((B, S, mpps), -1, np.int32)
        ntok = np.zeros((B, S, mpps), np.int32)
        wpage = np.full((B, S), -1, np.int32)
        wslot = np.zeros((B,), np.int32)
        for i, seq in enumerate(seqs):
            pos = self.seq_tokens[seq] - 1
            for s, mgr in enumerate(self.mgrs):
                if seq not in mgr.tables:
                    continue
                table = mgr.tables[seq]
                loc_tok = mgr.seq_tokens[seq]
                n = len(table.ppn)
                if n > mpps:
                    raise ValueError(f"mpps {mpps} too small for {n}")
                for vp in range(n):
                    if table.ppn[vp] >= 0:
                        tables[i, s, vp] = table.ppn[vp]
                        ntok[i, s, vp] = min(ptok, loc_tok - vp * ptok)
            # write target = page holding `pos` (the tail page just appended)
            ftok = self.geo.frame_pages * ptok
            s = self._shard_of_frame(pos // ftok)
            table = self.mgrs[s].tables[seq]
            wpage[i, s] = table.ppn[len(table.ppn) - 1]
            wslot[i] = pos % ptok

        def dev(a):
            return torch.from_numpy(a).to(device)

        return PageCtx(tables=dev(tables), ntok=dev(ntok), wpage=dev(wpage),
                       wslot=dev(wslot), frame_pages=self.geo.frame_pages)

    def pack_dual(self, seqs: Sequence[int], shard: int, max_frames: int,
                  max_pages: int, *, device="cpu"):
        """Per-shard dual-granularity tables on ``device``.

        Returns (frame_tables, frame_ntok, page_tables, page_ntok) int32
        [B, max_frames] / [B, max_pages]: coalesced vframes go to the frame
        list (one entry per frame), everything else to the page list.
        """
        B = len(seqs)
        fp, ptok = self.geo.frame_pages, self.geo.page_tokens
        ft = np.full((B, max_frames), -1, np.int32)
        fn = np.zeros((B, max_frames), np.int32)
        pt = np.full((B, max_pages), -1, np.int32)
        pn = np.zeros((B, max_pages), np.int32)
        mgr = self.mgrs[shard]
        for i, seq in enumerate(seqs):
            if seq not in mgr.tables:
                continue
            table = mgr.tables[seq]
            loc_tok = mgr.seq_tokens[seq]
            fi = pi = 0
            for vf in range(table.num_vframes):
                vpns = table.vpns_of_vframe(vf)
                if vf < len(table.coalesced) and table.coalesced[vf]:
                    ok, pframe = table.vframe_contiguous_aligned(vf)
                    assert ok
                    ft[i, fi] = pframe
                    fn[i, fi] = min(fp * ptok, loc_tok - vf * fp * ptok)
                    fi += 1
                else:
                    for vp in vpns:
                        if table.ppn[vp] >= 0:
                            pt[i, pi] = table.ppn[vp]
                            pn[i, pi] = max(0, min(ptok,
                                                   loc_tok - vp * ptok))
                            pi += 1
        return tuple(torch.from_numpy(a).to(device) for a in (ft, fn, pt, pn))

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for m in self.mgrs:
            for k, v in m.stats().items():
                agg[k] = agg.get(k, 0.0) + float(v)
        n = len(self.mgrs)
        for k in ("occupancy", "coalesced_fraction", "memory_bloat"):
            if k in agg:
                agg[k] /= n
        return agg

    def check_invariants(self):
        for m in self.mgrs:
            m.check_invariants()
