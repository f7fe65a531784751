"""The comparison that decides ``correct`` for a served model.

After the window, with the program freed, a sample of the requests served
by its close, finished or still in flight (drawn from the seed: the one
with the most served tokens, the one with the most tokens decoded after a
preemption and its fault-in, then others at random until
``sample_tokens`` served tokens or ``sample_requests`` requests), is run
once through the configuration's plain reference: the prompt and the
served tokens as one sequence, the weights drawn again from the seed.
For each served token the reference gives the gap by which its logit lies
below the reference's best at that position (0 where the reference
agrees with the greedy choice).  Two numbers summarise a sample:
``gap_max``, the widest gap, and ``gap_mean``, the mean over the served
tokens; each that the cell's ``limits`` names is held to its limit.

With ``control`` the precision control is put in the program's place:
the same sequences through the reference in fp8 (``Reference(quant=
"fp8")``), and at each position the full-precision reference's gap of the
token the fp8 forward ranks first.  Its gaps go through the same
comparison with the same limits, and a sound limit finds it not correct.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.lib import weights

# rid, prompt, served tokens, tokens decoded after a preemption
Served = Tuple[int, np.ndarray, List[int], int]


def sample(served: Sequence[Served], seed: int, min_tokens: int,
           max_requests: int) -> List[Served]:
    if not served:
        return []
    rng = np.random.default_rng([seed, 2])
    pool = sorted(served, key=lambda f: f[0])
    picked = [max(pool, key=lambda f: (len(f[2]), -f[0]))]
    most = max(pool, key=lambda f: (f[3], -f[0]))
    if most[3] > 0 and most is not picked[0]:
        picked.append(most)
    rest = [f for f in pool if all(f is not p for p in picked)]
    for i in rng.permutation(len(rest)):
        if len(picked) >= max_requests or \
                sum(len(p[2]) for p in picked) >= min_tokens:
            break
        picked.append(rest[i])
    return picked


def _setup(conf: dict, ref, seed: int, device: str):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, conf["torch_dtype"])
    return weights.make(ref.param_shapes(conf), ref.init, seed, dtype,
                        torch.device(device))


def _rows(item: Served, device):
    _rid, prompt, out, _ = item
    T = len(prompt)
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(out[:-1], np.int64)])
    toks = torch.from_numpy(seq).to(device)
    rows = torch.arange(T - 1, T - 1 + len(out), device=device)
    served = torch.tensor(out, dtype=torch.long, device=device)
    return toks, rows, served, T


def served_gaps(conf: dict, ref, seed: int, picked: Sequence[Served],
                page_tokens: int, device: str,
                control: bool = False) -> Dict[str, np.ndarray]:
    """Per served token: ``gap`` of the served token under the reference;
    with ``control``, ``control_gap`` of the fp8 reference's first choice."""
    W = _setup(conf, ref, seed, device)
    full = ref.Reference(conf, W)
    low = ref.Reference(conf, W, quant="fp8") if control else None
    gaps, cgaps = [], []
    for item in picked:
        toks, rows, served, T = _rows(item, device)
        lg = full.logits(toks, rows, T, page_tokens)
        best = lg.max(-1).values
        gaps.append((best - lg.gather(1, served[:, None])[:, 0]).cpu())
        if low is not None:
            lq = low.logits(toks, rows, T, page_tokens)
            pick = lq.argmax(-1)
            cgaps.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
        del lg
    out = {"gap": torch.cat(gaps).numpy() if gaps else np.zeros(0)}
    if control:
        out["control_gap"] = torch.cat(cgaps).numpy() if cgaps \
            else np.zeros(0)
    return out


def verdict(g: np.ndarray, limits: dict) -> dict:
    """The numbers of one side's gaps, each held to its limit."""
    numbers = summary(g)
    compared = {k: (numbers[k], lim) for k, lim in limits.items()}
    return {"correct": bool(g.size) and all(v <= lim for v, lim
                                            in compared.values()),
            "compared": compared, "numbers": numbers}


def check(conf: dict, ref, seed: int, picked: Sequence[Served],
          page_tokens: int, device: str, limits: dict,
          control: bool = False) -> dict:
    """The program's verdict, its numbers each with its limit and, with
    ``control``, the control's verdict by the same comparison."""
    t0 = time.perf_counter()
    gaps = served_gaps(conf, ref, seed, picked, page_tokens, device, control)
    g = gaps["gap"]
    out = verdict(g, limits)
    out["control"] = verdict(gaps["control_gap"], limits) if control \
        else None
    out["info"] = {"tokens": int(g.size), "requests": len(picked),
                   "reference_s": time.perf_counter() - t0,
                   "resumed_tokens_in_sample": sum(p[3] for p in picked),
                   "disagree": int((g > 0).sum())}
    return out


def summary(g: np.ndarray) -> Dict[str, float]:
    """The sample's numbers (infinite where nothing was compared)."""
    if not g.size:
        return {"gap_max": float("inf"), "gap_mean": float("inf")}
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean())}
