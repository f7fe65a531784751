"""The one traffic generator: reads a mix's parameters from its data file
(``portbench/traffic/<name>.json``) and yields requests from a seed.

A mix is a stream of blocks of ``block`` requests.  Every block holds the
same requests in the same order: each length (every prompt segment, the
output) and each inter-arrival gap takes the block's stratified quantiles
of its distribution ((i + 1/2) / block for i < block), and each tenant
its weight's share of the slots, paired and ordered by one fixed shuffle
that no seed changes.  The seed draws the token ids.  So every seed offers
the same work (on the card, seeds that also reordered each block spread
``qwen2.5-3b.oversub``'s ``out_tok_s`` over 71-85 tokens/s in one set of
six runs).

Keys: ``kind`` ("backlog": a queue kept at ``queued_per_slot`` x the
cell's ``max_batch`` requests, no arrival times), ``tenants`` (each with
``priority``, ``weight`` and ``prefix_tokens``: a tenant-wide prompt
prefix, drawn once per seed), ``prompt`` (segments concatenated after the
tenant's prefix, each {"dist": "loguniform" | "uniform", "min", "max"}),
``output`` (the number of tokens to generate, same form).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List

import numpy as np

PAIRING_SEED = 20240917      # the fixed shuffle of a block's sizes


@dataclasses.dataclass
class Spec:
    """One generated request (before the engine's ``Request`` wraps it)."""
    index: int
    tenant: int
    priority: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    prefix_tokens: int          # tokens shared with the tenant's others


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, as ints."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.rint(v).astype(np.int64)


def tenant_slots(tenants: List[dict], n: int) -> np.ndarray:
    """Tenant index of each of a block's n slots, by weight (largest
    remainders fill what rounding leaves)."""
    w = np.array([t["weight"] for t in tenants], dtype=np.float64)
    share = w / w.sum() * n
    count = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - count), kind="stable")[:n - count.sum()]:
        count[i] += 1
    return np.repeat(np.arange(len(tenants)), count)


def mean_lengths(traffic: dict) -> dict:
    """Mean prompt and output tokens of the mix (exact over one block)."""
    n = traffic["block"]
    prefix = np.array([t["prefix_tokens"] for t in traffic["tenants"]])
    slots = tenant_slots(traffic["tenants"], n)
    prompt = sum(quantiles(s, n).mean() for s in traffic["prompt"])
    return {"prompt": float(prompt + prefix[slots].mean()),
            "output": float(quantiles(traffic["output"], n).mean())}


def stream(traffic: dict, seed: int, vocab: int) -> Iterator[Spec]:
    """Requests of the mix, endless, the same for the same seed."""
    rng = np.random.default_rng(seed)
    n = traffic["block"]
    tenants = traffic["tenants"]
    prefixes = [rng.integers(0, vocab, t["prefix_tokens"]).astype(np.int32)
                for t in tenants]
    fixed = np.random.default_rng(PAIRING_SEED)
    seg_q = [fixed.permutation(quantiles(s, n)) for s in traffic["prompt"]]
    out_q = fixed.permutation(quantiles(traffic["output"], n))
    slots = fixed.permutation(tenant_slots(tenants, n))
    if traffic["kind"] != "backlog":
        raise ValueError(f"unknown kind of mix {traffic['kind']!r}")
    index = 0
    while True:
        for i in range(n):
            ten = int(slots[i])
            body = rng.integers(0, vocab, int(sum(q[i] for q in seg_q)))
            prompt = np.concatenate([prefixes[ten], body.astype(np.int32)])
            yield Spec(index=index, tenant=ten,
                       priority=int(tenants[ten]["priority"]),
                       prompt=prompt, max_new=int(out_q[i]),
                       prefix_tokens=int(tenants[ten]["prefix_tokens"]))
            index += 1
