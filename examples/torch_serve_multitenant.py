"""Multi-tenant serving on the Mosaic pool — the paper's setting as an
LLM-serving system.

Three tenants submit batched requests to one engine sharing one physical
KV pool.  The run reports, per manager (mosaic vs gpu-mmu baseline):
tokens/s, coalesced fraction (TLB-reach analogue), CAC compaction traffic,
and verifies the outputs are bit-identical — the manager is
application-transparent, the paper's headline property.

With ``--oversubscribe F`` the pool holds only 1/F of the sized-for-peak
KV working set (DESIGN.md §6): low-priority requests get preempted to the
host tier under pool pressure and resumed later via base-page demand
fault-in; the report adds swap counts, faults, merged-DMA counts and
modeled I/O-bus microseconds — and the outputs still match the
pressure-free run token-for-token.

With ``--shared-prefix N`` every prompt starts with the same N-token
system prompt (the multi-tenant reuse setting, DESIGN.md §8): finished
requests park the prefix's KV pages in the content-hash prefix cache,
and later admissions fault them back in through the DMA pipeline instead
of re-decoding them — watch ``prefix hit/miss`` and ``tok reused`` in
the report, and the eviction/parking gathers riding the duplex "out"
lanes.  ``--no-prefix-cache`` disables reuse for comparison (tokens are
byte-identical either way).

With ``--engines N`` the same workload runs on a cluster of N engine
replicas over one shared host tier (DESIGN.md §10): the deadline-aware
router load-balances admissions, the shared content-hash index lets a
prefix parked by one replica hit on every other, and work stealing
migrates preempted requests between replicas through host-frame leases
(zero re-prefill).  Outputs stay byte-identical to the 1-engine run.

With ``--capacity-frames N`` (cluster mode) host DRAM itself is bounded
to N frames and the disk spill tier opens underneath (DESIGN.md §11):
LRU frames ride the outbound DMA lanes into frame-granular disk files
and promote back on touch; ``--no-spill`` switches to the hard-capped
baseline that drops over-cap prefix frames through the index instead.
Tokens are byte-identical in every configuration — watch the ``spill``
line of the cluster summary.

    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 10
    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 12 \
        --oversubscribe 2
    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 12 \
        --shared-prefix 40
    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 12 \
        --shared-prefix 40 --engines 2
    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 12 \
        --shared-prefix 40 --engines 2 --capacity-frames 4

The PyTorch port's copy of ``examples/serve_multitenant.py``: the same
smoke config, pool geometry, request draws, waves and flags on
``repro_torch``'s ``ServingEngine`` and ``ServingCluster``, which make the
reference's allocation, fault, DMA and routing decisions, so the modeled
counters it prints are the reference's.  The engines run on ``--device``
(default ``cuda``: the Hopper kernels; ``cpu``: their plain versions) and
raise without a card rather than fall back; tok/s is measured on that
device's host clock.  The weights are drawn from torch's generator at
``--seed`` (the reference draws its own from ``jax.random``), so the
tokens differ from the reference's unless ``run(params=...)`` is given
its weights; across the two managers they are identical either way.

    PYTHONPATH=src python examples/torch_serve_multitenant.py --requests 12 \
        --shared-prefix 40 --device cpu
"""

import argparse
from typing import Mapping, Optional

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig, PoolGeometry
from repro_torch.serving.cluster import ServingCluster
from repro_torch.serving.engine import Request, ServingEngine


def run(manager_kind: str, n_requests: int, seed: int,
        oversubscribe: float = 1.0, fault_mode: str = "async",
        shared_prefix: int = 0, prefix_cache: bool = True,
        n_engines: int = 1, capacity_frames=None, spill: bool = True,
        translation: str = "off", *, device="cuda",
        params: Optional[Mapping] = None,
        cfg: Optional[ModelConfig] = None):
    """The reference's ``run`` on ``device``; ``params`` (a state_dict)
    and ``cfg`` (default: the smoke qwen2.5-3b) replace the seeded weights
    and the config."""
    cfg = cfg or get_smoke_config("qwen2.5-3b")
    geo = PoolGeometry(page_tokens=8, frame_pages=4, compact_threshold=0.4)
    if n_engines > 1:
        cluster = ServingCluster(
            cfg, geometry=geo, n_engines=n_engines, max_batch=4,
            max_seq=128, manager_kind=manager_kind, seed=seed,
            oversubscription=oversubscribe, fault_mode=fault_mode,
            prefix_cache=prefix_cache,
            capacity_frames=capacity_frames, spill=spill,
            translation=translation, device=device)
        if params is not None:       # the replicas share this one LM
            cluster.engines[0].lm.load_state_dict(params)
        eng = cluster            # same submit/run_until_drained surface
    else:
        cluster = None
        eng = ServingEngine(cfg, geometry=geo, max_batch=4, max_seq=128,
                            manager_kind=manager_kind, seed=seed,
                            oversubscription=oversubscribe,
                            fault_mode=fault_mode,
                            prefix_cache=prefix_cache,
                            translation=translation, params=params,
                            device=device)
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size,
                          shared_prefix).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        T = int(rng.integers(16, 72)) if oversubscribe == 1.0 \
            else int(rng.integers(56, 104))
        prompt = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
        if shared_prefix:
            prompt = np.concatenate([system, prompt])
        reqs.append(Request(
            rid=i, tenant=i % 3,
            # Tenant 0 is the premium tier: its requests are never the
            # preemption victim while lower tiers are runnable.
            priority=1 if i % 3 == 0 else 0,
            prompt=prompt,
            max_new=int(rng.integers(4, 12))))
    # With a shared prefix, submit in two waves so the first completions
    # park the prefix before the rest admit (reuse needs a warm index).
    wave1 = reqs[:2] if shared_prefix else reqs
    for r in wave1:
        eng.submit(r)
    steps = eng.run_until_drained(max_steps=5000)
    for r in reqs[len(wave1):]:
        eng.submit(r)
    steps += eng.run_until_drained(max_steps=5000)
    assert all(r.done for r in reqs)
    return eng, reqs, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--oversubscribe", type=float, default=1.0,
                    help="pool = sized-for-peak working set / this factor")
    ap.add_argument("--fault-mode", choices=("async", "sync"),
                    default="async",
                    help="async = double-buffered prefetch pipeline "
                         "(DESIGN.md §7); sync = blocking fault-in")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of shared system prompt prepended to "
                         "every request (prefix-cache reuse, DESIGN.md §8)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable content-hash prefix reuse (comparison)")
    ap.add_argument("--engines", type=int, default=1,
                    help="serving-engine replicas over one shared host "
                         "tier (cluster tier + router, DESIGN.md §10)")
    ap.add_argument("--capacity-frames", type=int, default=None,
                    help="bound host DRAM to this many frames and open "
                         "the disk spill tier underneath (DESIGN.md §11; "
                         "cluster mode only)")
    ap.add_argument("--no-spill", action="store_true",
                    help="with --capacity-frames: hard-cap baseline — "
                         "evict over-cap prefix frames instead of "
                         "spilling them to disk")
    ap.add_argument("--translation", choices=("off", "flat", "radix"),
                    default="off",
                    help="meter KV page translations through the "
                         "coalesced-TLB + radix-walker model "
                         "(DESIGN.md §15); prints a per-app "
                         "translation-cycle summary line")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the Hopper kernels; cpu: their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.capacity_frames is not None and args.engines < 2:
        ap.error("--capacity-frames needs --engines >= 2 (the bounded "
                 "host tier is a cluster feature)")

    results = {}
    for kind in ("mosaic", "gpu-mmu"):
        eng, reqs, steps = run(kind, args.requests, args.seed,
                               args.oversubscribe, args.fault_mode,
                               shared_prefix=args.shared_prefix,
                               prefix_cache=not args.no_prefix_cache,
                               n_engines=args.engines,
                               capacity_frames=args.capacity_frames,
                               spill=not args.no_spill,
                               translation=args.translation,
                               device=args.device)
        if args.engines > 1:
            cluster_stats = eng.stats()
            s = cluster_stats.totals
            st = {}
            for e in eng.engines:
                for k, v in e.cache.stats().items():
                    st[k] = st.get(k, 0.0) + v / len(eng.engines)
        else:
            cluster_stats = None
            st = eng.cache.stats()
            s = eng.stats
        where = (eng.engines[0] if args.engines > 1 else eng).device.type
        line = (f"[{kind:8}] {steps} engine steps | "
                f"{s.tok_per_s():7.1f} tok/s ({where}) | "
                f"coalesced {s.coalesced_mean:5.1%} | "
                f"CAC copies {s.compaction_copies} | "
                f"bloat {st.get('memory_bloat', 1):.2f}")
        if args.oversubscribe > 1.0:
            line += (f" | swaps {s.swaps_out}/{s.swaps_in} | "
                     f"faults {s.faults} in {s.fault_dmas} DMAs | "
                     f"{s.bytes_in / 1024:.0f} KiB in | "
                     f"{s.transfer_us:.0f} us bus "
                     f"({s.fault_hidden_us:.0f} hidden / "
                     f"{s.fault_exposed_us:.0f} exposed)")
        if args.shared_prefix:
            line += (f" | prefix {s.prefix_hits}/{s.prefix_misses} "
                     f"hit/miss | {s.prefix_reused_tokens} tok reused | "
                     f"admit {s.admit_hit_mean_us() / 1e3:.0f} ms hit vs "
                     f"{s.admit_cold_mean_us() / 1e3:.0f} ms cold | "
                     f"out {s.bytes_out / 1024:.0f} KiB")
        print(line)
        if cluster_stats is not None:
            for sub in cluster_stats.summary().splitlines():
                print(f"           {sub}")
        else:
            print(f"           {s.summary()}")
        if args.translation != "off":
            engines = eng.engines if args.engines > 1 else [eng]
            for e in engines:
                print(f"           engine[{e.engine_id}] "
                      f"{e.translation_meter.summary()}")
        results[kind] = {r.rid: tuple(r.out) for r in reqs}

    same = results["mosaic"] == results["gpu-mmu"]
    print(f"\napplication-transparency: outputs identical across managers "
          f"= {same}")
    assert same
    return results


if __name__ == "__main__":
    main()
