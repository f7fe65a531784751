"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.train_profile
        [--arch qwen2.5-3b --batch 2 --seq 2048 --remat block] [--layers N]
        [--grad-compress]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m \\
        repro_torch.launch.train_profile --model 2 --backend gloo --layers 18

Builds the port's ``Trainer`` for an architecture at its published width
(fp32 master weights from ``--seed``), runs ``--warm`` steps, times
``--steps`` more on the host clock (each ends in reading its loss, a
synchronisation), and traces ``--trace-steps`` with ``torch.profiler``:
device time by kernel per step, grouped (flash forward, flash backward,
matrix products, the rest), and the device's busy share of an unprofiled
step.  Then, on one more step's gradients, the optimizer alone (CUDA
events): the global norm, and the whole AdamW update that includes it.
For the ssm and hybrid families (``--arch mamba2-1.3b``, ``zamba2-1.2b``)
the SSD scan's forward and backward kernels are groups of their own.
``--layers N`` cuts the depth to N layers at the published widths (a MoE
model's dense-FFN layers count among them), so that a model whose training
state does not fit the card whole (deepseek-v2-lite-16b: ``--layers 5``)
can be profiled; the JSON line names the cut under ``reduced``.
``--grad-compress`` trains with the int8 compression of the gradients
(on one device: ``Q(g + e)`` and the new error feedback per leaf) and
also times that pass alone on one step's gradients.  ``--model N`` traces
a rank's step under tensor parallelism: run it under ``torchrun
--nproc-per-node W`` (mesh (W / N, N), megatron), on W cards over NCCL or,
with ``--backend gloo``, as W gloo ranks sharing one card (their step
times then share it too); rank 0 prints.  The JSON line
carries the caching allocator's retries (``num_alloc_retries``: each
frees the cache and synchronises) and its reserved high-water mark.

Prints one JSON object as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

# Kernel-name substrings of each group, first match wins.
GROUPS = (("flash_forward", ("flash_attention_tc_kernel",
                             "flash_attention_kernel")),
          ("flash_backward", ("bwd_dkdv", "bwd_dq", "bwd_rowdot")),
          ("ssd_backward", ("ssd_bwd_",)),
          ("ssd_forward", ("ssd_states_kernel", "ssd_pass_kernel",
                           "ssd_out_kernel", "ssd_scan_f32_kernel")),
          ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="block",
                    choices=["none", "block", "save_collectives"])
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace-steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks (under torchrun)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="gloo: the torchrun ranks share cuda:0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh, init_distributed
    mesh, rank = None, 0
    if "WORLD_SIZE" in os.environ:          # under torchrun
        init_distributed("cuda", backend=args.backend)
        world, rank = dist.get_world_size(), dist.get_rank()
        if world % args.model:
            raise SystemExit(f"train_profile: --model {args.model} does not "
                             f"divide {world} ranks")
        mesh = Mesh((world // args.model, args.model), ("data", "model"))
    elif args.model > 1:
        raise SystemExit(f"train_profile: --model {args.model} runs under "
                         f"torchrun --nproc-per-node {args.model}")

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainHParams
    from repro_torch.train.grad_compress import (
        compressed_allreduce_flat,
        pad_to_block,
    )
    from repro_torch.train.optimizer import adamw_update, global_norm
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    reduced = None
    if args.layers is not None:
        if not 0 < args.layers <= cfg.n_layers:
            raise SystemExit(f"train_profile: --layers {args.layers} not in "
                             f"1..{cfg.n_layers}")
        reduced = f"depth {cfg.n_layers} -> {args.layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    n = args.warm + args.steps + args.trace_steps
    hp = TrainHParams(lr=3e-4, warmup_steps=2, total_steps=n,
                      remat=args.remat, grad_compress=args.grad_compress)
    tr = Trainer(cfg, hp, batch_per_step=args.batch, seq_len=args.seq,
                 seed=args.seed, mesh=mesh, device=torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    tr.run(args.warm, log_every=1)
    tr.start_step = args.warm
    tr.run(args.steps, log_every=1)
    step_ms = sum(r["ms"] for r in tr.log[-args.steps:]) / args.steps
    tr.start_step = args.warm + args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        tr.run(args.trace_steps, log_every=1)
        wall = time.perf_counter() - w0
    # Device-side events only: the operator events above them carry the
    # same device time again.
    kernels = [(ev.key, ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and ev.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    per = args.trace_steps
    groups = {}
    for name, us, _ in kernels:
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / per * 1e-3
    busy_ms = sum(groups.values())

    def event_ms(fn):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    remat = {"none": False, "block": True}.get(args.remat, args.remat)
    st = tr.step_fn
    tr.lm.loss(st._rows(tr.data.batch_at(n)), remat=remat,
               par=st.par)[0].backward()
    grads = {name: p.grad for name, p in tr.params.items()}
    norm_ms = event_ms(lambda: global_norm(grads.values()))
    compress_ms = None
    if args.grad_compress:
        ef = tr.step_fn.ef

        def compress_all():     # one leaf's outputs alive at a time
            for name, g in grads.items():
                compressed_allreduce_flat(pad_to_block(g)[0], ef[name], None)
        compress_ms = event_ms(compress_all)
    mem = torch.cuda.memory_stats()
    adamw_ms = event_ms(lambda: adamw_update(st.shards(), grads, tr.opt, hp))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    tokens = args.batch * args.seq
    out = {
        "device": smi.stdout.strip().splitlines()[0] if smi.stdout
        else torch.cuda.get_device_name(0),
        "arch": cfg.name, "reduced": reduced, "batch": args.batch,
        "seq": args.seq, "remat": args.remat,
        "mesh": tr.mesh.shape, "backend": (dist.get_backend()
                                           if mesh is not None else None),
        "grad_compress": args.grad_compress,
        "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "trace_step_ms": wall / per * 1e3,
        "device_busy_ms_per_step": busy_ms,
        # Against the unprofiled step: tracing slows the host, not the card.
        "device_busy_share": busy_ms / step_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        "num_alloc_retries": mem["num_alloc_retries"],
        "groups_ms_per_step": groups,
        "global_norm_ms": norm_ms,
        "adamw_update_ms": adamw_ms,
        "compress_ms": compress_ms,
        "top_kernels_ms_per_step": [
            {"name": name[:90], "group": group_of(name),
             "ms": us / per * 1e-3, "calls": c // per}
            for name, us, c in kernels[:15]],
    }
    if rank == 0:
        print(json.dumps(out))
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
