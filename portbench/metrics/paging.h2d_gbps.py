"""Host tier: fault-in bytes copied to the card over the host-clock seconds
of those synchronised copies, in GB/s (EngineStats h2d_bytes / h2d_s)."""


def read(r):
    s = r["stats"]
    if not s["h2d_s"]:
        return None
    return s["h2d_bytes"] / s["h2d_s"] / 1e9
