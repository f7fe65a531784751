"""Quickstart: the Mosaic memory manager in 60 seconds.

Shows the paper's three components working on a live pool:
  1. CoCoA en-masse allocation  -> contiguity conserved
  2. In-Place Coalescer         -> metadata-only large pages (zero copies)
  3. CAC                        -> fragmentation -> splinter + compact

and the contrast with the GPU-MMU baseline (paper Fig. 2): same workload,
interleaved frames, zero coalescing opportunities.

    PYTHONPATH=src python examples/torch_quickstart.py

The PyTorch port's copy of ``examples/quickstart.py``: the same run on
``repro_torch.core``'s copies of the managers, which make the reference's
allocation decisions, so it prints the reference's lines.  Host-side only:
no kernel runs, so it takes no ``--device``.
"""

import argparse

from repro_torch.core.baseline_mmu import BaselineMMU
from repro_torch.core.manager import MosaicManager
from repro_torch.core.pagepool import PoolConfig

CFG = PoolConfig(num_pages=64, frame_pages=8, page_tokens=64,
                 compact_threshold=0.5)


def show(mgr, title):
    s = mgr.stats()
    print(f"  [{title}] occupancy={s['occupancy']:.0%} "
          f"coalesced={s['coalesced_fraction']:.0%} "
          f"bloat={s['memory_bloat']:.2f} "
          f"copies={s.get('compaction_copies', 0)}")


def run():
    print("== Mosaic: en-masse allocation from two tenants")
    mosaic = MosaicManager(CFG)
    baseline = BaselineMMU(CFG)
    # Two applications allocate interleaved buffers (paper Fig. 2 setting).
    for rep in range(2):
        for owner in (0, 1):
            mosaic.allocate_tokens(owner, 9 * CFG.page_tokens)
            baseline.allocate_tokens(owner, 9 * CFG.page_tokens)
    show(mosaic, "mosaic   ")
    show(baseline, "gpu-mmu  ")
    print(f"  baseline frames holding >1 app: "
          f"{baseline.multi_owner_frames()} "
          f"(coalesce opportunities: {baseline.coalesce_opportunities})")
    print(f"  mosaic coalesce ops: {mosaic.pool.stats['coalesce_ops']} "
          f"with {mosaic.pool.stats['compaction_copies']} copies "
          f"(in-place promotion)")

    print("\n== Deallocation: tenant 0 exits; tenant 1 trims -> CAC")
    mosaic.deallocate(0)
    t1 = mosaic.table(1)
    mosaic.free_pages(1, t1.mapped_vpns()[1::3])   # fragment tenant 1
    plan = mosaic.drain_copy_ops()
    show(mosaic, "after CAC")
    print(f"  CAC plan: {len(plan)} page copies "
          f"(device batch for the page_compact kernel)")
    mosaic.check_invariants()
    print("  invariants: OK")

    print("\n== Decode-time growth: appended pages coalesce at frame fill")
    mgr = MosaicManager(CFG)
    for step in range(CFG.frame_pages * CFG.page_tokens):
        mgr.append_tokens(7, 1)
    print(f"  after {CFG.frame_pages * CFG.page_tokens} tokens: "
          f"vframe0 coalesced = {mgr.table(7).coalesced[0]} "
          f"(copies: {mgr.pool.stats['compaction_copies']})")



def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    run()


if __name__ == "__main__":
    main()
