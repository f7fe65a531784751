"""Plain float32 reference of a dense GQA decoder (Qwen2-style).

Pre-norm blocks: RMSNorm, grouped-query attention with q/k/v biases and
rotate-half RoPE over the whole head, a SwiGLU feed-forward, a final
RMSNorm and the (tied) embedding as the output head.  Plain ``torch``
operations only, in float32 with TF32 off; it imports nothing of the
program.  The weights are the benchmark's own (``portbench/lib/weights.py``
draws them from the seed); their names and shapes are the ones the port's
``LM`` loads (``param_shapes``), which the harness checks before a run.

``Reference(conf, weights, quant="fp8")`` is the precision control: every
product's weight and input fake-quantised to float8 e4m3 (per output
column and per row), the step below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

ATTN_ROWS = 1024          # query rows per attention block (memory bound)


def dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    H = conf["num_attention_heads"]
    return {"d": d, "L": conf["num_hidden_layers"], "H": H,
            "Hkv": conf["num_key_value_heads"], "dh": d // H,
            "f": conf["intermediate_size"], "V": conf["vocab_size"]}


def port_fields(conf: dict) -> dict:
    """The port's ``ModelConfig`` fields that this file states."""
    return {"n_layers": conf["num_hidden_layers"],
            "d_model": conf["hidden_size"],
            "n_heads": conf["num_attention_heads"],
            "n_kv_heads": conf["num_key_value_heads"],
            "d_ff": conf["intermediate_size"],
            "vocab_size": conf["vocab_size"],
            "qkv_bias": conf["qkv_bias"],
            "rope_theta": float(conf["rope_theta"]),
            "norm_eps": float(conf["rms_norm_eps"]),
            "tie_embeddings": conf["tie_word_embeddings"],
            "dtype": conf["torch_dtype"]}


def param_shapes(conf: dict) -> Dict[str, Tuple[int, ...]]:
    m = dims(conf)
    d, L, H, Hkv, dh, f, V = (m[k] for k in ("d", "L", "H", "Hkv", "dh",
                                             "f", "V"))
    s = {"embed": (V, d), "final_norm": (d,),
         "decoder.ln1": (L, d), "decoder.ln2": (L, d),
         "decoder.attn.wq": (L, d, H, dh), "decoder.attn.wk": (L, d, Hkv, dh),
         "decoder.attn.wv": (L, d, Hkv, dh), "decoder.attn.wo": (L, H, dh, d),
         "decoder.mlp.w_gate": (L, d, f), "decoder.mlp.w_up": (L, d, f),
         "decoder.mlp.w_down": (L, f, d)}
    if conf["qkv_bias"]:
        s.update({"decoder.attn.bq": (L, H, dh),
                  "decoder.attn.bk": (L, Hkv, dh),
                  "decoder.attn.bv": (L, Hkv, dh)})
    if not conf["tie_word_embeddings"]:
        s["unembed"] = (d, V)
    return s


def init(name: str, shape: Sequence[int]) -> Tuple[str, float]:
    """How the benchmark draws a weight: ("normal", std) or ("const", v)."""
    leaf = name.split(".")[-1]
    if leaf in ("final_norm", "ln1", "ln2", "kv_norm"):
        return ("const", 1.0)
    if leaf in ("embed", "unembed", "bq", "bk", "bv"):
        return ("normal", 0.02)
    fan_in = shape[1] * shape[2] if leaf == "wo" else shape[1]
    return ("normal", fan_in ** -0.5)


def counts(conf: dict) -> dict:
    """Per-token work of the model as its shapes define it: weights of the
    layers a token passes (multiply-adds), of the output head, the KV bytes
    a cached token holds, and the widths an attended key costs."""
    m = dims(conf)
    d, L, H, Hkv, dh, f, V = (m[k] for k in ("d", "L", "H", "Hkv", "dh",
                                             "f", "V"))
    attn = d * H * dh + 2 * d * Hkv * dh + H * dh * d
    return {"layer_params": L * (attn + 3 * d * f), "head_params": d * V,
            "kv_bytes_per_token": L * 2 * Hkv * dh * 2,
            "layers": L, "heads": H, "kv_heads": Hkv, "qk_dim": dh,
            "v_dim": dh}


# ---------------------------------------------------------------- math


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotate-half RoPE over the last dim of x [T, heads, dim]."""
    dim = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=x.device) / dim)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one absmax scale per slice along
    ``dim`` (the scale reaches e4m3's largest normal, 448)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def causal_attention(q, k, v, scale):
    """q [T, H, dq], k [T, Hkv, dq], v [T, Hkv, dv] -> [T, H, dv], each
    query over the keys at or before it, in blocks of query rows."""
    T, H, _ = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    out = torch.empty((T, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for i in range(0, T, ATTN_ROWS):
        j = min(T, i + ATTN_ROWS)
        qb = q[i:j].reshape(j - i, Hkv, g, -1)
        s = torch.einsum("qngd,knd->ngqk", qb, k[:j]) * scale
        qpos = torch.arange(i, j, device=q.device)[:, None]
        kpos = torch.arange(j, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("ngqk,knd->qngd", p, v[:j])
        out[i:j] = o.reshape(j - i, H, -1)
    return out


class Reference:
    """Float32 forward of the configuration over one token sequence."""

    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.conf, self.w, self.quant = conf, weights, quant
        self.m = dims(conf)
        self.eps = float(conf["rms_norm_eps"])

    def lin(self, x, w):
        """x [T, in] @ w [in, out] in float32, or through fp8."""
        w = w.float()
        if self.quant == "fp8":
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w

    def _layer(self, x, l, pos):
        m, w = self.m, self.w
        d, H, Hkv, dh = m["d"], m["H"], m["Hkv"], m["dh"]
        T = x.shape[0]
        h = rms(x, w["decoder.ln1"][l].float(), self.eps)
        q = self.lin(h, w["decoder.attn.wq"][l].reshape(d, H * dh))
        k = self.lin(h, w["decoder.attn.wk"][l].reshape(d, Hkv * dh))
        v = self.lin(h, w["decoder.attn.wv"][l].reshape(d, Hkv * dh))
        if self.conf["qkv_bias"]:
            q = q + w["decoder.attn.bq"][l].float().reshape(-1)
            k = k + w["decoder.attn.bk"][l].float().reshape(-1)
            v = v + w["decoder.attn.bv"][l].float().reshape(-1)
        theta = float(self.conf["rope_theta"])
        q = rope(q.view(T, H, dh), pos, theta)
        k = rope(k.view(T, Hkv, dh), pos, theta)
        o = causal_attention(q, k, v.view(T, Hkv, dh), dh ** -0.5)
        x = x + self.lin(o.reshape(T, H * dh),
                         w["decoder.attn.wo"][l].reshape(H * dh, d))
        h = rms(x, w["decoder.ln2"][l].float(), self.eps)
        a = F.silu(self.lin(h, w["decoder.mlp.w_gate"][l])) \
            * self.lin(h, w["decoder.mlp.w_up"][l])
        return x + self.lin(a, w["decoder.mlp.w_down"][l])

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, rows: torch.Tensor,
               prompt_len: int, page_tokens: int) -> torch.Tensor:
        """Logits [len(rows), V] at positions ``rows`` of ``tokens`` [T]
        (the prompt, then the served tokens).  ``prompt_len`` and
        ``page_tokens`` do not change a dense model's forward."""
        del prompt_len, page_tokens
        w = self.w
        x = w["embed"][tokens.long()].float()
        pos = torch.arange(x.shape[0], device=x.device)
        for l in range(self.m["L"]):
            x = self._layer(x, l, pos)
        x = rms(x[rows.long()], w["final_norm"].float(), self.eps)
        head = w["embed"].T if self.conf["tie_word_embeddings"] \
            else w["unembed"]
        return self.lin(x, head)
