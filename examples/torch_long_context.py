"""Long-context decode with host-DRAM demand paging (paper §1's trade-off).

A single sequence's KV cache exceeds the device pool, so cold pages live
in host DRAM and fault in at *base-page* granularity while translation
(the packed tables the kernel consumes) still works at *frame*
granularity — Mosaic's whole point, demonstrated end to end:

  * prefill a long prompt -> en-masse allocation, frames coalesce;
  * decode with a page-granular residency tracker: each step's working
    set faults in per page (small transfers), never per frame;
  * the same run with frame-granular faulting over-fetches ~16x.

    PYTHONPATH=src python examples/torch_long_context.py --ctx 4096

The PyTorch port's copy of ``examples/long_context.py``: the same run on
``repro_torch.core``'s copies of the manager and the residency tracker,
which make the reference's allocation and fault decisions, so it prints
the reference's lines.  Host-side only: no kernel runs, so it takes no
``--device``.
"""

import argparse

import numpy as np

from repro_torch.core.demand_paging import LinkModel, ResidencyTracker
from repro_torch.core.manager import MosaicManager
from repro_torch.core.pagepool import PoolConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=64)
    ap.add_argument("--frame-pages", type=int, default=16)
    args = ap.parse_args(argv)
    run(args.ctx, args.decode_steps, args.page_tokens, args.frame_pages)


def run(ctx: int, decode_steps: int = 64, page_tokens: int = 64,
        frame_pages: int = 16):
    ptok, fp = page_tokens, frame_pages
    pages = (ctx + ptok - 1) // ptok
    pool_pages = ((pages * 2 + fp - 1) // fp) * fp
    mgr = MosaicManager(PoolConfig(num_pages=pool_pages, frame_pages=fp,
                                   page_tokens=ptok))
    kv_page_bytes = ptok * 8 * 128 * 2 * 2      # kv=8 heads, dh=128, bf16, k+v
    link = LinkModel()

    # Prefill: en-masse allocation; frames coalesce with zero copies.
    mgr.allocate_tokens(0, ctx)
    t = mgr.table(0)
    print(f"prefill {ctx} tokens -> {t.num_pages} pages, "
          f"{sum(t.coalesced)}/{t.num_vframes} vframes coalesced, "
          f"copies={mgr.pool.stats['compaction_copies']}")

    # Decode with page-granular vs frame-granular demand paging.
    rng = np.random.default_rng(0)
    for granularity, span in (("page", 1), ("frame", fp)):
        tracker = ResidencyTracker(pool_pages, kv_page_bytes, link)
        total_us = 0.0
        for step in range(decode_steps):
            # Attention sparsely revisits history (sliding window + a few
            # random lookback pages) — the regime where paging wins.
            recent = list(range(max(0, t.num_pages - 4), t.num_pages))
            lookback = rng.integers(0, t.num_pages, size=4).tolist()
            need_vpns = sorted(set(recent + lookback))
            ppns = []
            for v in need_vpns:
                base = (t.ppn[v] // span) * span
                ppns.extend(range(base, base + span))
            batch = tracker.fault_in(ppns)
            total_us += batch.transfer_us
        s = tracker.stats
        print(f"[{granularity:5}-granular faults] faults={s['faults']:4d} "
              f"bytes_in={s['bytes_in'] / 1e6:7.2f} MB "
              f"transfer={total_us / 1e3:6.2f} ms")

    print("\npage-granular transfer moves only what the step touches; "
          "frame-granular over-fetches the rest of each frame — Mosaic "
          "gives frame-level translation WITH page-level transfer.")


if __name__ == "__main__":
    main()
