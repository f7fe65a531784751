"""Multi-application GPGPU workload generator for the TLB/paging simulator.

The paper evaluates 235 workloads built from 27 applications (Parboil, SHOC,
LULESH, Rodinia, CUDA SDK).  We cannot execute CUDA binaries; instead each
application is a *synthetic profile* — working-set size, access-pattern mix
(streaming / strided / hotspot), and memory intensity — chosen to span the
paper's range from TLB-friendly (high locality, small footprint) to
TLB-thrashing (large footprint, low locality).  Names mirror the suites for
readability; parameters are synthetic (disclosed in DESIGN.md §2).

Crucially, *allocation behaviour* is not synthetic: every workload allocates
its buffers through a real manager (:class:`MosaicManager` or
:class:`BaselineMMU`) with en-masse, per-buffer mallocs interleaved across
the concurrently-running applications — reproducing the paper's Fig. 2
setting where frame interleaving is what denies the baseline any coalescing
opportunity.  The resulting vpn→(ppn, frame, coalesced-bit) mapping is what
the TLB simulator translates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.manager import MosaicManager
from repro_torch.core.baseline_mmu import BaselineMMU
from repro_torch.core.pagepool import PoolConfig
from repro_torch.core.tlb_sim import AppTrace

# Paper geometry: 4KB base pages, 2MB frames → 512 pages/frame.
PAPER_FRAME_PAGES = 512


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """One application, at *macro-access* (page-dwell) granularity.

    A trace entry is one warp-dwell on one 4KB page; the warp issues
    ``page_repeat`` memory instructions into that page (cache-line
    iteration) taking ``gap_cycles`` of compute.  The TLB is consulted once
    per dwell — dwell-internal instructions hit the just-filled entry.
    """

    name: str
    ws_pages: int          # working set, in 4KB base pages
    n_access: int          # trace length (page dwells simulated)
    gap_cycles: int        # compute cycles per dwell (arithmetic intensity)
    p_stream: float        # fraction of sequential-scan dwells
    p_hot: float           # fraction of hotspot (reuse-heavy) dwells
    zipf_a: float = 1.2    # hotspot skew
    stride: int = 7        # page stride of the remaining dwells
    buffers: int = 6       # number of en-masse mallocs the app performs
    page_repeat: int = 24  # memory instructions per dwell (for reporting)


# 27 application profiles spanning the paper's suites (synthetic parameters:
# working sets 10MB–64MB, i.e. 5–32× the 128-entry L1 TLB reach and up to
# 8× the 512-entry L2 reach, matching the paper's "poor TLB reach" regime).
APP_PROFILES: Dict[str, AppProfile] = {
    p.name: p
    for p in [
        # Parboil
        AppProfile("sad",        8192, 24000, 420, 0.70, 0.15),
        AppProfile("histo",      4096, 24000, 520, 0.30, 0.55, 1.4),
        AppProfile("bfs",       16384, 24000, 300, 0.10, 0.35, 1.1),
        AppProfile("mri-q",      2560, 24000, 900, 0.80, 0.10),
        AppProfile("sgemm",      6144, 24000, 1100, 0.85, 0.10),
        AppProfile("spmv",      12288, 24000, 340, 0.25, 0.30, 1.1),
        AppProfile("stencil",    8192, 24000, 600, 0.90, 0.05),
        AppProfile("tpacf",      3072, 24000, 850, 0.50, 0.40, 1.5),
        AppProfile("lbm",       16384, 24000, 460, 0.92, 0.03),
        AppProfile("cutcp",      4096, 24000, 700, 0.60, 0.30, 1.3),
        # SHOC
        AppProfile("shoc-md",    6144, 24000, 640, 0.40, 0.40, 1.3),
        AppProfile("shoc-fft",   8192, 24000, 800, 0.75, 0.15),
        AppProfile("shoc-scan", 12288, 24000, 480, 0.95, 0.02),
        AppProfile("shoc-sort", 12288, 24000, 400, 0.55, 0.20),
        AppProfile("shoc-spmv", 16384, 24000, 320, 0.25, 0.30, 1.1),
        # LULESH
        AppProfile("lulesh",    16384, 24000, 540, 0.45, 0.25, 1.2),
        # Rodinia
        AppProfile("backprop",   4096, 24000, 680, 0.70, 0.20),
        AppProfile("gaussian",   2560, 24000, 760, 0.75, 0.20),
        AppProfile("hotspot",    4096, 24000, 720, 0.85, 0.10),
        AppProfile("kmeans",     8192, 24000, 440, 0.50, 0.35, 1.4),
        AppProfile("lud",        3072, 24000, 860, 0.80, 0.12),
        AppProfile("nw",         6144, 24000, 580, 0.88, 0.06),
        AppProfile("pathfinder", 8192, 24000, 620, 0.90, 0.05),
        AppProfile("srad",       8192, 24000, 560, 0.86, 0.08),
        # CUDA SDK
        AppProfile("blackscholes", 6144, 24000, 740, 0.95, 0.02),
        AppProfile("dct",        2560, 24000, 880, 0.80, 0.12),
        AppProfile("reduction", 12288, 24000, 500, 0.97, 0.01),
    ]
}

APP_NAMES: List[str] = sorted(APP_PROFILES)


def _gen_vpns(p: AppProfile, rng: np.random.Generator) -> np.ndarray:
    """Synthesize the virtual page access stream for one app."""
    n, ws = p.n_access, p.ws_pages
    kinds = rng.choice(
        3, size=n, p=[p.p_stream, p.p_hot, max(0.0, 1 - p.p_stream - p.p_hot)]
    )
    idx = np.arange(n)
    # Streaming: piecewise-sequential page sweeps, mean run length 64 pages.
    new_run = rng.random(n) < 1.0 / 64
    new_run[0] = True
    run_id = np.cumsum(new_run) - 1
    run_starts = rng.integers(0, ws, size=int(run_id[-1]) + 1)
    first_idx = np.maximum.accumulate(np.where(new_run, idx, 0))
    offset = idx - first_idx
    seq = (run_starts[run_id] + offset) % ws
    # Hotspot: zipf-ranked over a random permutation of the working set.
    ranks = rng.zipf(p.zipf_a, size=n) - 1
    perm = rng.permutation(ws)
    hot = perm[np.minimum(ranks, ws - 1)]
    # Strided: same run structure, wider page steps.
    strided = (run_starts[run_id] + p.stride * offset) % ws
    vpn = np.where(kinds == 0, seq, np.where(kinds == 1, hot, strided))
    return vpn.astype(np.int32)


def _manager(kind: str, total_pages: int) -> MosaicManager | BaselineMMU:
    cfg = PoolConfig(
        num_pages=total_pages,
        frame_pages=PAPER_FRAME_PAGES,
        page_tokens=1,  # 1 "token" == 1 base page for the simulator
    )
    return MosaicManager(cfg) if kind == "mosaic" else BaselineMMU(cfg)


def build_workload(
    names: Sequence[str],
    manager_kind: str,
    seed: int = 0,
    n_access: int | None = None,
) -> Tuple[List[AppTrace], object]:
    """Allocate + trace a multi-application workload through a real manager.

    Buffers are allocated round-robin across the applications (per-buffer
    en-masse mallocs) — the interleaving that defeats the baseline GPU-MMU's
    coalescing opportunities in the paper's Fig. 2.
    """
    rng = np.random.default_rng(seed)
    profiles = [APP_PROFILES[n] for n in names]
    total = sum(p.ws_pages for p in profiles)
    # Pool sized with 25% headroom, frame-aligned.
    pool_pages = int(np.ceil(total * 1.25 / PAPER_FRAME_PAGES)) * PAPER_FRAME_PAGES
    mgr = _manager(manager_kind, pool_pages)
    # Round-robin per-buffer allocation.  CUDA mallocs are base-page- but not
    # frame-aligned: jitter buffer sizes so they do not divide into 2MB
    # frames — the interleaving of paper Fig. 2 that denies the baseline any
    # coalescing opportunity (CoCoA is immune: it re-packs per owner).
    remaining = {i: p.ws_pages for i, p in enumerate(profiles)}
    chunk = {
        i: max(1, p.ws_pages // p.buffers) for i, p in enumerate(profiles)
    }
    live = set(remaining)
    while live:
        for i in sorted(live):
            jitter = int(rng.integers(-PAPER_FRAME_PAGES // 8,
                                      PAPER_FRAME_PAGES // 8))
            take = min(max(1, chunk[i] + jitter), remaining[i])
            mgr.allocate_tokens(i, take)
            remaining[i] -= take
            if remaining[i] == 0:
                live.discard(i)
    # Translate traces through each app's page table.
    traces = []
    for i, p in enumerate(profiles):
        table = mgr.table(i)
        ppn_of_vpn = np.asarray(table.ppn, dtype=np.int32)
        coalesced_of_vframe = np.asarray(table.coalesced, dtype=np.int8)
        prof = (
            p if n_access is None else dataclasses.replace(p, n_access=n_access)
        )
        vpn = _gen_vpns(prof, rng)
        ppn = ppn_of_vpn[vpn]
        frame = ppn // PAPER_FRAME_PAGES
        coalesced = coalesced_of_vframe[vpn // PAPER_FRAME_PAGES]
        traces.append(
            AppTrace(
                vpn=vpn,
                ppn=ppn,
                frame=frame,
                coalesced=coalesced,
                gap_cycles=p.gap_cycles,
                name=p.name,
                # The allocator's actual vpn→ppn map: the radix model
                # derives coalesced-entry coverage from it (DESIGN.md §15).
                ppn_map=ppn_of_vpn,
            )
        )
    return traces, mgr


def homogeneous_names(app: str, n: int) -> List[str]:
    return [app] * n


def heterogeneous_names(k: int, seed: int) -> List[str]:
    rng = np.random.default_rng(1000 + seed)
    return list(rng.choice(APP_NAMES, size=k, replace=False))
