"""Manager: whole-request preemptions (swaps out) per 1,000 output tokens
(EngineStats swaps_out, window delta)."""


def read(r):
    if not r["out_tokens"]:
        return None
    return r["stats"]["swaps_out"] / r["out_tokens"] * 1e3
