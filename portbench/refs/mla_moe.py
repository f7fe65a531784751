"""Plain float32 reference of a DeepSeek-V2-style decoder: multi-head
latent attention (MLA) and routed plus shared experts.

Layer l: x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x)), where the FFN is a
dense SwiGLU for the first ``first_k_dense_replace`` layers and, after
them, the softmax router's top-k experts (gates renormalised over the k)
plus the always-on shared experts.  MLA in its expanded form: q =
h W_q split into a no-RoPE and a RoPE part; the latent c = RMSNorm(h W_DKV);
per-head keys [c W_UK, RoPE(h W_KR)] and values c W_UV; scale (nope +
rope)^-1/2.  Plain ``torch`` operations, float32, TF32 off; nothing of the
program is imported.

The configuration states the engine's capacity rule (``capacity_factor``):
within one prefill of a prompt right-padded to a page multiple ``Tp``,
expert e keeps the first C = ceil(Tp * k / E * capacity_factor) selections
in token order and drops the rest (the pad tokens come after every real
one, so they never displace one); a decoded token is a forward of its own
(C = 1 for each of its k distinct experts), so it drops nothing.
``quant="fp8"`` is the precision control, as in ``dense.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.refs.dense import causal_attention, fake_fp8, rms, rope


def dims(conf: dict) -> dict:
    return {"d": conf["hidden_size"], "L": conf["num_hidden_layers"],
            "H": conf["num_attention_heads"], "V": conf["vocab_size"],
            "f": conf["intermediate_size"],
            "fe": conf["moe_intermediate_size"],
            "E": conf["n_routed_experts"], "k": conf["num_experts_per_tok"],
            "S": conf["n_shared_experts"],
            "Ld": conf["first_k_dense_replace"],
            "r": conf["kv_lora_rank"], "nope": conf["qk_nope_head_dim"],
            "rope": conf["qk_rope_head_dim"], "dv": conf["v_head_dim"]}


def port_fields(conf: dict) -> dict:
    m = dims(conf)
    return {"n_layers": m["L"], "d_model": m["d"], "n_heads": m["H"],
            "n_kv_heads": conf["num_key_value_heads"], "d_ff": m["f"],
            "vocab_size": m["V"], "head_dim": m["nope"] + m["rope"],
            "rope_theta": float(conf["rope_theta"]),
            "norm_eps": float(conf["rms_norm_eps"]),
            "tie_embeddings": conf["tie_word_embeddings"],
            "dtype": conf["torch_dtype"],
            "moe": {"n_experts": m["E"], "top_k": m["k"], "d_expert": m["fe"],
                    "n_shared": m["S"], "first_dense": m["Ld"],
                    "capacity_factor": float(conf["capacity_factor"])},
            "mla": {"kv_lora_rank": m["r"],
                    "q_lora_rank": conf["q_lora_rank"] or 0,
                    "qk_nope_head_dim": m["nope"],
                    "qk_rope_head_dim": m["rope"], "v_head_dim": m["dv"]}}


def _attn_shapes(m, L, pre):
    d, H, r = m["d"], m["H"], m["r"]
    return {f"{pre}.attn.wq": (L, d, H, m["nope"] + m["rope"]),
            f"{pre}.attn.w_dkv": (L, d, r), f"{pre}.attn.w_kr": (L, d, m["rope"]),
            f"{pre}.attn.kv_norm": (L, r),
            f"{pre}.attn.w_uk": (L, r, H, m["nope"]),
            f"{pre}.attn.w_uv": (L, r, H, m["dv"]),
            f"{pre}.attn.wo": (L, H, m["dv"], d),
            f"{pre}.ln1": (L, d), f"{pre}.ln2": (L, d)}


def param_shapes(conf: dict) -> Dict[str, Tuple[int, ...]]:
    m = dims(conf)
    d, V, Ld, Lm = m["d"], m["V"], m["Ld"], m["L"] - m["Ld"]
    E, fe, fs = m["E"], m["fe"], m["S"] * m["fe"]
    s = {"embed": (V, d), "final_norm": (d,), "unembed": (d, V)}
    if Ld:
        s.update(_attn_shapes(m, Ld, "decoder_prefix"))
        s.update({"decoder_prefix.mlp.w_gate": (Ld, d, m["f"]),
                  "decoder_prefix.mlp.w_up": (Ld, d, m["f"]),
                  "decoder_prefix.mlp.w_down": (Ld, m["f"], d)})
    s.update(_attn_shapes(m, Lm, "decoder"))
    s.update({"decoder.moe.router": (Lm, d, E),
              "decoder.moe.w_gate": (Lm, E, d, fe),
              "decoder.moe.w_up": (Lm, E, d, fe),
              "decoder.moe.w_down": (Lm, E, fe, d)})
    if m["S"]:
        s.update({"decoder.moe.ws_gate": (Lm, d, fs),
                  "decoder.moe.ws_up": (Lm, d, fs),
                  "decoder.moe.ws_down": (Lm, fs, d)})
    if conf["tie_word_embeddings"]:
        del s["unembed"]
    return s


def init(name: str, shape: Sequence[int]) -> Tuple[str, float]:
    """How the benchmark draws a weight: ("normal", std) or ("const", v)."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf in ("final_norm", "ln1", "ln2", "kv_norm"):
        return ("const", 1.0)
    if leaf in ("embed", "unembed"):
        return ("normal", 0.02)
    if "moe" in parts and leaf in ("w_gate", "w_up", "w_down"):
        fan_in = shape[2]                       # [L, E, in, out]
    elif leaf == "wo":
        fan_in = shape[1] * shape[2]            # [L, H, dv, d]
    else:
        fan_in = shape[1]
    return ("normal", fan_in ** -0.5)


def counts(conf: dict) -> dict:
    """Per-token work as the shapes define it (see ``dense.counts``): the
    expanded MLA form, k routed plus the shared experts and the router."""
    m = dims(conf)
    d, H, r = m["d"], m["H"], m["r"]
    qk = m["nope"] + m["rope"]
    attn = (d * H * qk + d * r + d * m["rope"] + r * H * m["nope"]
            + r * H * m["dv"] + H * m["dv"] * d)
    moe = 3 * d * m["fe"] * (m["k"] + m["S"]) + d * m["E"]
    return {"layer_params": m["L"] * attn + m["Ld"] * 3 * d * m["f"]
            + (m["L"] - m["Ld"]) * moe,
            "head_params": d * m["V"],
            "kv_bytes_per_token": m["L"] * (r + m["rope"]) * 2,
            "layers": m["L"], "heads": H, "kv_heads": 1, "qk_dim": qk,
            "v_dim": m["dv"]}


class Reference:
    """Float32 forward of the configuration over one token sequence."""

    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.conf, self.w, self.quant = conf, weights, quant
        self.m = dims(conf)
        self.eps = float(conf["rms_norm_eps"])
        self.cf = float(conf["capacity_factor"])

    def lin(self, x, w):
        w = w.float()
        if self.quant == "fp8":
            x, w = fake_fp8(x, -1), fake_fp8(w, 0)
        return x @ w

    def _mla(self, h, pre, l, pos):
        m, w = self.m, self.w
        d, H, r, nope, rp, dv = (m[k] for k in ("d", "H", "r", "nope",
                                                "rope", "dv"))
        T = h.shape[0]
        g = lambda n: w[f"{pre}.attn.{n}"][l]
        theta = float(self.conf["rope_theta"])
        q = self.lin(h, g("wq").reshape(d, -1)).view(T, H, nope + rp)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        lat = rms(self.lin(h, g("w_dkv")), g("kv_norm").float(), self.eps)
        k_rope = rope(self.lin(h, g("w_kr"))[:, None, :], pos, theta)
        k_nope = self.lin(lat, g("w_uk").reshape(r, -1)).view(T, H, nope)
        v = self.lin(lat, g("w_uv").reshape(r, -1)).view(T, H, dv)
        k = torch.cat([k_nope, k_rope.expand(T, H, rp)], dim=-1)
        o = causal_attention(q, k, v, (nope + rp) ** -0.5)
        return self.lin(o.reshape(T, H * dv), g("wo").reshape(H * dv, d))

    def _moe(self, h, l, prompt_len, padded_len):
        """Routed experts with the capacity rule over the prompt's rows
        (a forward of ``padded_len`` rows), none dropped after it, plus
        the shared experts."""
        m, w = self.m, self.w
        E, k = m["E"], m["k"]
        g = lambda n: w[f"decoder.moe.{n}"][l]
        probs = torch.softmax(h @ g("router").float(), dim=-1)
        gates, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, sel = gates[:, :k], sel[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        keep = torch.ones_like(sel, dtype=torch.bool)
        P = prompt_len
        C = max(1, math.ceil(padded_len * k / E * self.cf))
        onehot = F.one_hot(sel[:P], E).sum(1)                 # [P, E]
        pos = torch.gather(torch.cumsum(onehot, 0), 1, sel[:P]) - 1
        keep[:P] = pos < C
        y = torch.zeros_like(h)
        for e in range(E):
            rows, slot = torch.nonzero((sel == e) & keep, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = h[rows]
            a = F.silu(self.lin(xe, g("w_gate")[e])) \
                * self.lin(xe, g("w_up")[e])
            ye = self.lin(a, g("w_down")[e])
            y.index_add_(0, rows, ye * gates[rows, slot][:, None])
        if m["S"]:
            a = F.silu(self.lin(h, g("ws_gate"))) * self.lin(h, g("ws_up"))
            y = y + self.lin(a, g("ws_down"))
        return y

    def _dense_ffn(self, h, l):
        g = lambda n: self.w[f"decoder_prefix.mlp.{n}"][l]
        a = F.silu(self.lin(h, g("w_gate"))) * self.lin(h, g("w_up"))
        return self.lin(a, g("w_down"))

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, rows: torch.Tensor,
               prompt_len: int, page_tokens: int) -> torch.Tensor:
        """Logits [len(rows), V] at positions ``rows`` of ``tokens`` [T]:
        the prompt's ``prompt_len`` tokens (prefilled as one forward padded
        to a multiple of ``page_tokens``), then the decoded ones."""
        m, w = self.m, self.w
        padded = -(-prompt_len // page_tokens) * page_tokens
        x = w["embed"][tokens.long()].float()
        pos = torch.arange(x.shape[0], device=x.device)
        for l in range(m["L"]):
            pre, ll = (("decoder_prefix", l) if l < m["Ld"]
                       else ("decoder", l - m["Ld"]))
            h = rms(x, w[f"{pre}.ln1"][ll].float(), self.eps)
            x = x + self._mla(h, pre, ll, pos)
            h = rms(x, w[f"{pre}.ln2"][ll].float(), self.eps)
            x = x + (self._dense_ffn(h, ll) if l < m["Ld"]
                     else self._moe(h, ll, prompt_len, padded))
        x = rms(x[rows.long()], w["final_norm"].float(), self.eps)
        head = w["embed"].T if self.conf["tie_word_embeddings"] \
            else w["unembed"]
        return self.lin(x, head)
