"""Where the serving time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile [--batch 4 --prompt 512]

Builds the port's engine for an architecture at its published width
(random weights from ``--seed``), admits ``--batch`` requests of
``--prompt`` tokens, and measures on the card:

* warm prefill: host ms per prompt token over admissions 2..batch,
  after the first one has paid CUDA's lazy start-up costs;
* decode: host ms per engine step over ``--steps`` steps, each ending in
  the argmax's device-to-host copy (a synchronisation);
* a ``torch.profiler`` trace of ``--trace-steps`` decode steps: device
  time by kernel name per step, and the device's busy share of an
  unprofiled step (the rest is the card waiting on the host).

Prints one JSON object as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace-steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import PoolGeometry
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config(args.arch)
    max_seq = 2 * (args.prompt + args.steps + args.trace_steps + 8)
    eng = ServingEngine(cfg, geometry=PoolGeometry(),
                        max_batch=args.batch, max_seq=max_seq,
                        seed=args.seed)
    rng = np.random.default_rng(args.seed)
    max_new = args.steps + args.trace_steps + 16

    def request(rid):
        return Request(rid=rid, tenant=rid % 3, max_new=max_new,
                       prompt=rng.integers(0, cfg.vocab_size, args.prompt)
                       .astype(np.int32))

    eng.submit(request(0))
    eng.step()                  # the first admission pays CUDA's start-up
    torch.cuda.synchronize()
    p0, t0 = eng.stats.prefill_s, eng.stats.prefill_tokens
    for rid in range(1, args.batch):
        eng.submit(request(rid))
    eng.step()                  # warm admissions of the rest of the batch
    warm_prefill_ms = ((eng.stats.prefill_s - p0)
                       / max(eng.stats.prefill_tokens - t0, 1) * 1e3)

    d0, n0 = eng.stats.decode_s, eng.stats.decode_steps
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (eng.stats.decode_s - d0) / (eng.stats.decode_steps - n0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        for _ in range(args.trace_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    # Device-side events only (kernels, memcpy, memset): the operator
    # events above them carry the same device time again.
    kernels = [(ev.key, ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_s = sum(k[1] for k in kernels) * 1e-6
    per = args.trace_steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {
        "device": smi.stdout.strip().splitlines()[0] if smi.stdout
        else torch.cuda.get_device_name(0),
        "arch": cfg.name, "batch": len(eng.active),
        "prompt_tokens": args.prompt,
        "warm_prefill_ms_per_token": warm_prefill_ms,
        "decode_step_ms": step_ms,
        "decode_tok_per_s": len(eng.active) / step_ms * 1e3,
        "trace_step_ms": wall / per * 1e3,
        "device_busy_ms_per_step": busy_s / per * 1e3,
        # Against the unprofiled step: tracing slows the host, not the card.
        "device_busy_share": busy_s / per * 1e3 / step_ms,
        "top_kernels_ms_per_step": [
            {"name": name[:80], "ms": us / per * 1e-3, "calls": n // per}
            for name, us, n in kernels[:12]],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
