"""Host tier: base pages faulted in per 1,000 output tokens (EngineStats
faults, window delta)."""


def read(r):
    if not r["out_tokens"]:
        return None
    return r["stats"]["faults"] / r["out_tokens"] * 1e3
