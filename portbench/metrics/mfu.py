"""Model step: model FLOPs of the tokens the window computed (from the
configuration's shapes and each token's context) over the window's
seconds times the card's bf16 peak, in %."""


def read(r):
    if r.get("model_flops") is None:
        return None
    return r["model_flops"] / (r["window_s"] * r["peak_flops"]) * 100
