"""Int8 block quantization of gradients (the reference's
``train/grad_compress.py``).

The quantizer is ported: :func:`_quant` / :func:`_dequant` give the
reference's bits on the same input.  The compressed ring all-reduce that
uses it needs more than one rank, and waits for the port's multi-device
work (ROADMAP Queue 1 item 6): until then :func:`compressed_allreduce_flat`
raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256

_MULTI_DEVICE = ("the compressed ring all-reduce needs several ranks; it "
                 "waits for multi-device training (ROADMAP Queue 1 item 6)")


def _quant(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [n] -> (int8 [n / BLOCK, BLOCK], scales fp32 [n / BLOCK])."""
    xb = x32.reshape(-1, BLOCK)
    scale = xb.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float().reshape(-1, BLOCK) * scale[:, None]).reshape(-1)


def _ring_allreduce_q(x32: torch.Tensor, axis: str) -> torch.Tensor:
    raise NotImplementedError(_MULTI_DEVICE)


def compressed_allreduce_flat(g32: torch.Tensor, err: torch.Tensor,
                              axis: str):
    raise NotImplementedError(_MULTI_DEVICE)


def pad_to_block(x: torch.Tensor, block: int = BLOCK):
    """x flattened and zero-padded to a multiple of ``block``; returns
    (padded, original size)."""
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % block)), n


def padded_size(n_elems: int, n_dev: int = 1) -> int:
    """Length after padding for an n_dev-ring of BLOCK-quantized chunks."""
    block = BLOCK * max(1, n_dev)
    return n_elems + (-n_elems) % block
