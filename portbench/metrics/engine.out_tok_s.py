"""Engine loop: every output token (first tokens included) of the steps
that started in the window, over their wall time, in tokens/s (host
clock)."""


def read(r):
    if not r["out_tokens"]:
        return None
    return r["out_tok_s"]
