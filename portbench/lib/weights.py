"""The weights of a run, drawn from its seed on the device.

One ``torch.Generator`` on the device, seeded with the run's seed, fills
every tensor in name order with one ``normal_`` (or ``fill_``) call each,
in the dtype the configuration serves in, as its reference's ``init``
says.  The same call on a tensor of the same shape, dtype and device gives
the same numbers, so the program's ``LM`` (filled in place) and the
reference (a fresh dict, drawn again after the program is freed) read the
same weights while neither takes them from the other.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

SEED_MOD = 2 ** 63


def fill(tensors: Iterable[Tuple[str, torch.Tensor]], init: Callable,
         seed: int) -> None:
    """Draw every (name, tensor) in name order from one generator."""
    items = sorted(tensors, key=lambda kv: kv[0])
    gen = torch.Generator(device=items[0][1].device)
    gen.manual_seed(seed % SEED_MOD)
    with torch.no_grad():
        for name, t in items:
            how, arg = init(name, tuple(t.shape))
            if how == "const":
                t.fill_(arg)
            else:
                t.normal_(0.0, arg, generator=gen)


def make(shapes: Dict[str, Tuple[int, ...]], init: Callable, seed: int,
         dtype, device) -> Dict[str, torch.Tensor]:
    """A fresh dict of the weights, as :func:`fill` draws them."""
    out = {n: torch.empty(s, dtype=dtype, device=device)
           for n, s in shapes.items()}
    fill(out.items(), init, seed)
    return out
