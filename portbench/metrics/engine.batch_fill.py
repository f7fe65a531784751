"""Engine loop: decode tokens per decode step over ``max_batch``, in %
(EngineStats counters, window deltas)."""


def read(r):
    s = r["stats"]
    if not s["decode_steps"]:
        return None
    return s["decode_tokens"] / s["decode_steps"] / r["max_batch"] * 100
