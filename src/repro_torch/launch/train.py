"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of the reference's ``launch/train.py``.  Under ``torchrun`` it
initialises the process group from torchrun's environment (NCCL on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``), builds the mesh of its
ranks (``make_host_mesh()``, or ``make_production_mesh()`` under
``--production-mesh``, which needs a world of 256 ranks) and trains the
fault-tolerant :class:`~repro_torch.train.trainer.Trainer` over it.  Run
alone, it trains on one device.  Restart the same command after a failure
or preemption: ``--resume`` restores the newest complete checkpoint and
re-shards it onto this run's ranks, whatever their number and mesh.
``make_host_mesh()`` gives ``model = min(4, ranks)``: under the default
``--parallelism megatron`` that axis carries tensor and expert
parallelism (the reference's explicit blocks), under ``auto`` each model
rank computes the whole model from gathered weights, and under ``fsdp`` it
carries batch rows like the others.

On the card, qwen2.5-3b, mamba2-1.3b or zamba2-1.2b at its published
width and depth:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 6 --batch 2 --seq 2048

The data is ``SyntheticLM``'s tokens, so the vlm and encdec families, whose
loss also takes frontend embeddings, are refused here: train them through
``make_train_step`` on batches that carry ``patch_embeds`` or
``src_embeds`` (``chip_smoke.py`` phases 9d and 9e do).

On the CPU (smoke-scale), on one process or four gloo ranks:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --smoke --device cpu --parallelism fsdp --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --smoke --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import TrainHParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", default="save_collectives",
                    choices=["none", "block", "save_collectives"])
    ap.add_argument("--parallelism", default="megatron",
                    choices=["megatron", "auto", "fsdp"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 (requires 256 ranks)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from repro_torch.launch.mesh import (
        init_distributed,
        make_host_mesh,
        make_production_mesh,
    )
    from repro_torch.train.trainer import Trainer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    if cfg.family in ("vlm", "encdec"):
        need = "patch_embeds" if cfg.family == "vlm" else "src_embeds"
        raise ValueError(
            f"{cfg.name} ({cfg.family}) trains on batches with frontend "
            f"embeddings ({need!r}) that SyntheticLM does not make: build "
            f"them and call repro_torch.train.trainer.make_train_step")
    hp = TrainHParams(lr=args.lr, total_steps=args.steps,
                      microbatch=args.microbatch, remat=args.remat,
                      parallelism=args.parallelism)
    device = args.device
    launched = "WORLD_SIZE" in os.environ        # under torchrun
    if launched:
        device = init_distributed(args.device)
    try:
        mesh = (make_production_mesh() if args.production_mesh
                else make_host_mesh())
        if not (dist.is_initialized() and dist.get_rank()):
            print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
                  f"device={device} mesh={mesh.shape} "
                  f"parallelism={hp.parallelism}")
        tr = Trainer(cfg, hp, batch_per_step=args.batch, seq_len=args.seq,
                     mesh=mesh, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     device=device)
        return tr.run(args.steps)
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
