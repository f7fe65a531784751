"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

Stands up the port's multi-tenant engine on the Mosaic pool (sync fault-in)
and replays a synthetic request stream; ``--manager gpu-mmu`` flips to the
baseline allocator.  Runs on ``cuda`` by default; ``--device cpu`` runs the
kernels' plain versions.  The cluster path (``--engines``) comes with a
later slice.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --requests 8 --max-new 8 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import PoolGeometry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--manager", default="mosaic",
                    choices=["mosaic", "gpu-mmu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="default: 8 for --smoke, 64 otherwise")
    ap.add_argument("--frame-pages", type=int, default=None,
                    help="default: 4 for --smoke, 16 otherwise")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    geo = PoolGeometry(
        page_tokens=args.page_tokens or (8 if args.smoke else 64),
        frame_pages=args.frame_pages or (4 if args.smoke else 16))
    eng = ServingEngine(cfg, geometry=geo, max_batch=args.max_batch,
                        max_seq=args.max_seq, manager_kind=args.manager,
                        seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        T = int(rng.integers(8, max(9, args.max_seq // 2)))
        r = Request(rid=i, tenant=i % 3,
                    prompt=rng.integers(0, cfg.vocab_size, T).astype(
                        np.int32),
                    max_new=args.max_new)
        reqs.append(r)
        eng.submit(r)
    steps = eng.run_until_drained()
    st = eng.cache.stats()
    print(f"[{args.manager}] {len(reqs)} requests in {steps} steps | "
          f"{eng.stats.tok_per_s():.1f} tok/s ({eng.device}) | "
          f"coalesced {eng.stats.coalesced_mean:.1%} | "
          f"CAC copies {eng.stats.compaction_copies} | "
          f"bloat {st.get('memory_bloat', 1.0):.2f}")
    print(eng.stats.summary())
    for r in reqs[:4]:
        print(f"  rid={r.rid} tenant={r.tenant} -> {r.out[:10]}")


if __name__ == "__main__":
    main()
