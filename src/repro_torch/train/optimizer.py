"""AdamW with warmup+cosine schedule and global-norm clipping.

Counterpart of the reference's ``train/optimizer.py``, on dicts of tensors
keyed by parameter name.  Master params are the fp32 params themselves
(the model casts to ``cfg.dtype`` at entry); the moments live in fp32 at
the params' shapes.  The arithmetic is the reference's, in its order: the
clip scale ``min(1, clip / max(gn, 1e-12))``, the bias corrections at the
incremented step, and ``p·(1 − lr·wd) − lr·m̂/(√v̂ + eps)`` in f32, cast
back to the parameter's dtype.  Scalars are f32 0-d tensors, as the
reference's are f32 arrays.

Unlike the reference's pure functions, :func:`adamw_update` updates the
params, the moments and the (f32) grads in place: at full width each copy
is 12 GB, and the card holds four of them.

Under data parallelism the update runs on this rank's shards (ZeRO-1 /
FSDP): each leaf's update is elementwise, and only the clip scale needs
the whole gradient.  :func:`global_norm` then sums, on each rank, the
squares of the shards it counts (every sharded leaf's shard, and a leaf
replicated over ranks only on its first replica) and all-reduces that sum
once, so that every leaf counts once and the scale is the same on every
rank.
"""

from __future__ import annotations

import math
from typing import Collection, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainHParams

Tensors = Dict[str, torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(hp: TrainHParams, step) -> torch.Tensor:
    """Linear warmup to ``hp.lr``, then cosine decay to a 0.1 floor at
    ``hp.total_steps``; ``step`` an int or an int 0-d tensor (CPU)."""
    step = torch.as_tensor(step).cpu()
    warm = torch.clamp(_f32(step) / _f32(max(hp.warmup_steps, 1)), max=1.0)
    t = torch.clamp(_f32(step - hp.warmup_steps)
                    / _f32(max(hp.total_steps - hp.warmup_steps, 1)),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    return _f32(hp.lr) * warm * (0.1 + 0.9 * cos)


def adamw_init(params: Tensors) -> Dict[str, object]:
    """{"step": int32 0-d (CPU), "mu": f32 zeros, "nu": f32 zeros} at the
    params' shapes and devices."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32), "mu": zeros(),
            "nu": zeros()}


def global_norm(tensors: Iterable[torch.Tensor], group=None,
                device=None) -> torch.Tensor:
    """sqrt of the sum over tensors of their f32 sums of squares; with
    ``group``, that sum is all-reduced over it first (each rank passing the
    shards it counts, perhaps none: then ``device`` places the zero)."""
    total = None
    for g in tensors:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    if group is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=device)
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state, hp: TrainHParams,
                 *, counted: Optional[Collection[str]] = None, group=None
                 ) -> Tuple[Tensors, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}); the
    params and ``state["mu"]`` / ``state["nu"]`` are updated in place,
    ``state["step"]`` is replaced, and f32 grads are overwritten (scaled,
    then squared).  Under data parallelism ``params``, ``grads`` and the
    moments are this rank's shards, ``counted`` names the leaves whose
    squares this rank adds to the grad norm (default: all) and ``group``
    the ranks that norm sums over (:func:`global_norm`)."""
    step = state["step"] + 1
    gn = global_norm((grads[n] for n in params
                      if counted is None or n in counted), group,
                     next(iter(params.values())).device)
    scale = torch.clamp(hp.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = lr_schedule(hp, step)
    c1 = 1 - _f32(hp.b1) ** step.float()
    c2 = 1 - _f32(hp.b2) ** step.float()
    decay = 1 - lr * hp.weight_decay
    for n, p in params.items():
        mu, nu = state["mu"][n], state["nu"][n]
        g = grads[n]
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        # Python floats, as the reference's: 1 - b1 is taken in double and
        # rounded to f32 once.
        mu.mul_(hp.b1).add_(g * (1 - hp.b1))
        nu.mul_(hp.b2).add_(g.square_().mul_(1 - hp.b2))
        upd = mu / c1
        upd.div_((nu / c2).sqrt_().add_(hp.eps)).mul_(lr)
        if p.dtype == torch.float32:
            p.mul_(decay).sub_(upd)
        else:
            p.copy_(p.float().mul_(decay).sub_(upd))
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}, {
        "grad_norm": gn, "lr": lr}
