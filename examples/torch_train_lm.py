"""End-to-end training driver: ~100M-param dense LM for a few hundred steps.

Demonstrates the full training substrate on whatever devices exist:
config -> mesh -> train step (remat, ZeRO-1) -> synthetic data
pipeline -> fault-tolerant loop (atomic checkpoints, SIGTERM-safe) ->
restart-and-resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 --resume

(~100M params is deliberate: big enough to be a real model, small enough
for CPU. On a TPU slice the same script runs with the production mesh.)

The PyTorch port's copy of ``examples/train_lm.py``: the same model,
hyperparameters, checkpoint cadence and printed lines on ``repro_torch``'s
``Trainer``, on ``--device`` (default ``cuda``, which raises without a card
rather than fall back; ``cpu`` trains there).  Run alone it trains on one
device; under ``torchrun`` it trains over the ranks ``make_host_mesh()``
finds (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``), as the
reference does on its devices.  ``--resume`` restores the newest complete
checkpoint bit for bit.  The weights are drawn from torch's generator at
seed 0 (the reference draws its own from ``jax.random``).

    PYTHONPATH=src python examples/torch_train_lm.py --tiny --steps 20 \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 examples/torch_train_lm.py \\
        --tiny --steps 20 --device cpu
"""

import argparse
import os
import tempfile
from typing import Mapping, Optional

import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig, TrainHParams
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.train.trainer import Trainer


def model_100m() -> ModelConfig:
    # llama-family dense decoder, ~100M params.
    return ModelConfig(
        name="demo-100m", family="dense",
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        d_ff=1536, vocab_size=32000, rope_theta=10000.0,
        tie_embeddings=True, source="examples/train_lm.py",
    )


def run(steps: int, batch: int = 8, seq: int = 256,
        ckpt_dir: Optional[str] = None, resume: bool = False,
        tiny: bool = False, device="cuda", *,
        params: Optional[Mapping] = None, cfg: Optional[ModelConfig] = None,
        ckpt_every: int = 50):
    """The reference's run on ``device``; returns (Trainer, history).
    ``params`` (a state_dict), ``cfg`` and ``ckpt_every`` replace the
    seeded weights, the model and the checkpoint cadence."""
    cfg = cfg or (get_smoke_config("llama3-8b") if tiny else model_100m())
    n_params_est = cfg.param_count()
    mesh = make_host_mesh()
    # Under torchrun rank 0 prints (the Trainer's step lines too).
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *_: None)
    say(f"model: {cfg.name} ({n_params_est / 1e6:.1f}M params)")

    hp = TrainHParams(lr=3e-4, warmup_steps=20, total_steps=steps,
                      microbatch=2, remat="block")
    say(f"mesh: {dict(mesh.shape)}")
    tr = Trainer(cfg, hp, batch, seq, mesh=mesh, ckpt_dir=ckpt_dir,
                 ckpt_every=ckpt_every, resume=resume, device=device,
                 params=params)
    if resume:
        say(f"resuming from step {tr.start_step}")
    hist = tr.run(steps, log_every=10)
    if hist:
        say(f"loss: {hist[0][1]:.3f} -> {hist[-1][1]:.3f} "
            f"over {len(hist)} logged points")
    return tr, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-sized model (CI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the Hopper kernels; cpu: their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    launched = "WORLD_SIZE" in os.environ        # under torchrun
    device = init_distributed(args.device) if launched else args.device
    try:
        return run(args.steps, args.batch, args.seq, args.ckpt_dir,
                   args.resume, args.tiny, device)
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
