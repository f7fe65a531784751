"""Int8 block-quantized ring all-reduce with error feedback.

Counterpart of the reference's ``train/grad_compress.py`` over a
``torch.distributed`` process group.  Gradients are reduced in int8 (+ f32
per-block scales, 1/256 overhead) instead of f32, with each rank's
quantization error carried in its own *error-feedback* buffer, so that the
optimizer sees an unbiased long-run gradient (Seide et al. 1-bit SGD /
EF-SGD line of work).

The ring is the reference's: a reduce-scatter of quantized chunks in D - 1
hops (each hop dequantizes what it receives, accumulates in f32 and
requantizes what it sends next), then an all-gather of the reduced chunks
in D - 1 hops.  Every hop sends the int8 payload and the f32 scales to rank
+ 1 of the group and receives from rank - 1 (``batch_isend_irecv``).  Each
rank feeds the ring its own gradient: the reference's trainer hands its
shard_map an already all-reduced gradient (``in_specs=P()``), so that its
ring adds rounding to an f32 reduction and replaces no wire bytes; the port
follows the module's stated intent instead.  On a one-rank group nothing
goes on the wire: the result is ``dequant(quant(g + e))``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

BLOCK = 256


def _quant(x32: torch.Tensor, work: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [n] -> (int8 [n / BLOCK, BLOCK], scales fp32 [n / BLOCK]).

    The reference's bits (max |x| from ``aminmax``; the division, rounding
    and clamping in place), in ``work`` (f32 [n], overwritten) when given,
    else in one temporary the size of ``x32``: the embedding leaf of a 3B
    model is 1.24 GB."""
    xb = x32.reshape(-1, BLOCK)
    lo, hi = torch.aminmax(xb, dim=1, keepdim=True)
    scale = torch.maximum(hi, lo.neg_()) / 127.0 + 1e-12
    y = torch.div(xb, scale, out=None if work is None
                  else work.view(-1, BLOCK))
    q = y.round_().clamp_(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [n / BLOCK, BLOCK] x scales -> f32 [n], into ``out`` if given."""
    out = q.float() if out is None else out.view(q.shape).copy_(q)
    return out.reshape(-1, BLOCK).mul_(scale[:, None]).reshape(-1)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _hop(q: torch.Tensor, s: torch.Tensor, group):
    """Send (q, s) to group rank + 1; return what group rank - 1 sent."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    rq, rs = torch.empty_like(q), torch.empty_like(s)
    ops = [dist.P2POp(dist.isend, q, nxt, group),
           dist.P2POp(dist.isend, s, nxt, group),
           dist.P2POp(dist.irecv, rq, prv, group),
           dist.P2POp(dist.irecv, rs, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return rq, rs


def _ring_allreduce_q(x32: torch.Tensor, group) -> torch.Tensor:
    """The int8 ring all-reduce (sum) of a flat f32 vector over ``group``;
    its length is a multiple of BLOCK x the group's size.  As the
    reference's, rank r ends holding chunk (r + 1) % D as its own f32 sum
    and every other chunk as the dequantized value its holder sent."""
    n_dev = _size(group)
    if n_dev == 1:
        return x32
    me = dist.get_rank(group)
    acc = x32.reshape(n_dev, -1).clone()
    # Reduce-scatter: after D-1 hops, rank `me` holds the full sum of
    # chunk (me + 1) % D.
    idx = me
    for _ in range(n_dev - 1):
        q, s = _hop(*_quant(acc[idx]), group)
        idx = (idx - 1) % n_dev
        acc[idx] += _dequant(q, s)
    # All-gather: circulate the reduced chunks D-1 hops, quantized.
    for _ in range(n_dev - 1):
        q, s = _hop(*_quant(acc[idx]), group)
        idx = (idx - 1) % n_dev
        acc[idx] = _dequant(q, s)
    return acc.reshape(-1)


def compressed_allreduce_flat(g32: torch.Tensor, err: torch.Tensor, group
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat f32 vector: returns (the mean over ``group``'s ranks, this
    rank's new error feedback).  Error feedback: e' = (g + e) - Q(g + e),
    kept locally.  ``group`` None or of one rank: no wire traffic, the mean
    is Q(g + e) itself.

    In place, for memory (the reference's bits all the same): ``err``
    becomes e' and is returned as it; ``g32`` is overwritten (the
    quantizer's work buffer, then Q(g + e), which one rank returns)."""
    n_dev = _size(group)
    x = err.add_(g32)
    xq = _dequant(*_quant(x, work=g32), out=g32)
    new_err = x.sub_(xq)
    if n_dev == 1:
        return xq, new_err
    return _ring_allreduce_q(xq, group).div_(n_dev), new_err


def pad_to_block(x: torch.Tensor, block: int = BLOCK):
    """x flattened and zero-padded to a multiple of ``block``; returns
    (padded, original size).  Without padding, the flat view of x."""
    n, flat = x.numel(), x.reshape(-1)
    pad = (-n) % block
    return (F.pad(flat, (0, pad)) if pad else flat), n


def padded_size(n_elems: int, n_dev: int = 1) -> int:
    """Length after padding for an n_dev-ring of BLOCK-quantized chunks.

    Each ring chunk (1/n_dev of the vector) must itself be a whole number
    of quantization blocks, so the vector pads to BLOCK * n_dev.
    """
    block = BLOCK * max(1, n_dev)
    return n_elems + (-n_elems) % block
