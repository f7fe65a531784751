"""The yardstick's arithmetic: the card's peaks, a kernel's least time from
the bytes and operations its shapes define, and a model's FLOPs.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity, at its 700 W limit).  The bytes / operations formulas are copies
of ``chip_smoke.py``'s ``bound_ms`` and ``flash_fwd_bound``, in seconds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """Least seconds: bytes at the HBM peak or operations at the bf16
    peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def flash_fwd_work(Tq: int, Tk_prefix: int, H: int, n_kv: int, dq: int,
                   dv: int) -> tuple:
    """(bytes, operations) of one causal prefill attention of ``Tq`` new
    rows over ``Tk_prefix`` cached keys and their own (B = 1): q, k, v
    read once and o written once in bf16 (lse in f32), and the two
    products over the pairs each row sees, Q K^T over ``dq`` and P V over
    ``dv``."""
    pairs = Tq * Tk_prefix + Tq * (Tq + 1) // 2
    rows_q, rows_kv = Tq * H, (Tq + Tk_prefix) * n_kv
    nbytes = 2 * rows_q * (dq + dv) + 2 * rows_kv * (dq + dv) + 4 * H * Tq
    return nbytes, 2 * H * pairs * (dq + dv)


def token_flops(counts: dict, new: int, context: int, head_rows: int) -> float:
    """Model FLOPs of ``new`` tokens computed at once after ``context``
    cached ones (causal among themselves), with the output head applied
    to ``head_rows`` rows: 2 per multiply-add of the layers' weights, and
    of the scores and the weighted sum over each key a row attends."""
    pairs = new * context + new * (new + 1) // 2
    attn = 2 * counts["layers"] * counts["heads"] * pairs \
        * (counts["qk_dim"] + counts["v_dim"])
    return 2.0 * counts["layer_params"] * new + attn \
        + 2.0 * counts["head_params"] * head_rows
