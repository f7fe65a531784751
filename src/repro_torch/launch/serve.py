"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id>``.

Stands up the port's multi-tenant engine on the Mosaic pool in the engine's
defaults (async fault-in and the prefix cache on, as the reference's
launcher) and replays a synthetic request stream; ``--manager gpu-mmu``
flips to the baseline allocator.  ``--engines N`` serves the stream from a
``ServingCluster`` of N replicas sharing one LM and one host tier, with the
deadline-aware router dispatching (``--router``) and, unless
``--no-migrate``, work-stealing across them; the tokens are the
single-engine run's.  ``--translation flat|radix`` meters each engine's KV
page translations and prints one summary line per engine.  Runs on
``cuda`` by default; ``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --requests 8 --max-new 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --requests 8 --max-new 8 --engines 2 --translation radix \\
        --device cpu

``--arch`` takes every id of the port's registry, the reference's ten: the
dense qwen2.5-3b, qwen3-8b (qk-norm), llama3-8b and phi3-mini-3.8b; the
vlm llava-next-mistral-7b (zero image embeddings in front of each prompt,
as the reference's stub); the encdec seamless-m4t-large-v2 (an encoder
over zero source frames, cross K/V kept per request); the moe
deepseek-v2-lite-16b (MLA) and dbrx-132b; the hybrid zamba2-1.2b (Mamba-2
layers plus a shared, paged attention block) and the attention-free
mamba2-1.3b (recurrent state, no KV pool).
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
    ap.add_argument("--engines", type=int, default=1,
                    help="engine replicas sharing one LM and one host tier "
                         "(cluster tier and deadline router)")
    ap.add_argument("--router", default="slack", choices=["slack", "fifo"],
                    help="cluster dispatch policy (with --engines > 1)")
    ap.add_argument("--no-migrate", action="store_true",
                    help="disable work-stealing migration between replicas "
                         "(with --engines > 1)")
    ap.add_argument("--translation", default="off",
                    choices=["off", "flat", "radix"],
                    help="meter KV page translations through the "
                         "coalesced-TLB + radix-walker model; prints a "
                         "per-engine translation summary line")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.serving.cluster import ServingCluster
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    geo = PoolGeometry(
        page_tokens=args.page_tokens or (8 if args.smoke else 64),
        frame_pages=args.frame_pages or (4 if args.smoke else 16))
    if args.engines > 1:
        eng = ServingCluster(cfg, geometry=geo, n_engines=args.engines,
                             max_batch=args.max_batch, max_seq=args.max_seq,
                             manager_kind=args.manager, seed=args.seed,
                             router_policy=args.router,
                             migrate=not args.no_migrate,
                             translation=args.translation,
                             device=args.device)
    else:
        eng = ServingEngine(cfg, geometry=geo, max_batch=args.max_batch,
                            max_seq=args.max_seq, manager_kind=args.manager,
                            seed=args.seed, translation=args.translation,
                            device=args.device)
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
    if args.engines > 1:
        print(f"[{args.manager}] {len(reqs)} requests in {steps} cluster "
              f"steps ({args.engines} engines on {args.device})")
        print(eng.stats().summary())
        engines = eng.engines
    else:
        st = eng.cache.stats()
        print(f"[{args.manager}] {len(reqs)} requests in {steps} steps | "
              f"{eng.stats.tok_per_s():.1f} tok/s ({eng.device}) | "
              f"coalesced {eng.stats.coalesced_mean:.1%} | "
              f"CAC copies {eng.stats.compaction_copies} | "
              f"bloat {st.get('memory_bloat', 1.0):.2f}")
        print(eng.stats.summary())
        engines = [eng]
    if args.translation != "off":
        for e in engines:
            print(f"  engine[{e.engine_id}] "
                  f"{e.translation_meter.summary()}")
    for r in reqs[:4]:
        print(f"  rid={r.rid} tenant={r.tenant} -> {r.out[:10]}")


if __name__ == "__main__":
    main()
