"""Parameter init helpers (the distributions of the reference's ``models/common.py``).

The reference draws from ``jax.random``; the port draws the same
distributions from an explicit ``torch.Generator``, so the numbers differ
from the reference's for the same seed.  Tests that compare the two
packages load the reference's weights through :mod:`repro_torch.bridge`
instead of re-drawing them.  :func:`unbind_layers` gives training its
per-layer weight trees (through :func:`train_weight`, which also gathers
an FSDP-sharded weight), and :func:`layer_remat` and :data:`ckpt` its
per-layer activation recomputation.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def empty_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, frozen weight (filled by ``init_`` or
    ``load_state_dict``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(t: torch.Tensor, in_axis: int,
                generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place: truncated-normal fan-in init (LeCun-style).

    Drawn in float32 (as the reference stores it) and cast once into
    ``t``'s dtype.
    """
    shape: Sequence[int] = t.shape
    fan_in = shape[in_axis] if len(shape) else 1
    scale = 1.0 / max(1.0, fan_in) ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(scale))
    return t


def embed_init_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with N(0, 1) · 0.02, drawn in float32."""
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=generator)
    with torch.no_grad():
        t.copy_(w.mul_(0.02))
    return t


def train_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """``w`` in ``dtype`` for a training forward: its whole value, gathered
    over the data-parallel ranks where the trainer keeps only this rank's
    shard of it (FSDP: the parameter then carries ``fsdp_gather(w, dtype)``,
    an all-gather whose backward reduce-scatters), else cast."""
    gather = getattr(w, "fsdp_gather", None)
    return w.to(dtype) if gather is None else gather(w, dtype)


def unbind_layers(named: Iterable[Tuple[str, torch.Tensor]], dtype,
                  n: int) -> List[Dict[str, object]]:
    """Per-layer weight trees of ``n`` layers from (name, weight [n, ...])
    pairs: ``ln1`` and ``attn.wq`` of layer l land at ``tree["ln1"]`` and
    ``tree["attn"]["wq"]``.  Each weight is cast to ``dtype`` once and
    unbound along its layer axis, so its gradient comes back as one
    stacked tensor; indexing the stacked weight per layer would make
    autograd build a full-size zero gradient for every layer (the
    reference casts its fp32 params at the loss's entry).  A sharded
    weight is gathered here (:func:`train_weight`)."""
    per_layer: List[Dict[str, object]] = [{} for _ in range(n)]
    for name, w in named:
        group, _, leaf = name.rpartition(".")
        for lp, wl in zip(per_layer, train_weight(w, dtype).unbind(0)):
            (lp.setdefault(group, {}) if group else lp)[leaf] = wl
    return per_layer


REMAT = (False, True, "none", "block", "save_collectives")


def layer_remat(remat) -> bool:
    """Whether a training stack recomputes each layer in the backward:
    every value of :data:`REMAT` except False and "none" (the reference's
    stacks other than the dense one wrap each layer in ``jax.checkpoint``
    when ``remat`` is truthy, so "save_collectives" recomputes whole
    layers there)."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not one of {REMAT}")
    return remat not in (False, "none")


# Per-layer activation recomputation (non-reentrant, no RNG state: the
# layers draw no random numbers).
ckpt = functools.partial(checkpoint, use_reentrant=False,
                         preserve_rng_state=False)
