"""Device: the share of the traced slice in which the card ran nothing
(one minus the union of its device intervals over the slice), in %."""


def read(r):
    t = r.get("trace")
    if not t or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
