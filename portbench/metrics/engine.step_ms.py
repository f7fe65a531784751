"""Engine loop: the window's seconds over the engine steps it ran, in ms
(host clock)."""


def read(r):
    if not r["engine_steps"]:
        return None
    return r["window_s"] / r["engine_steps"] * 1e3
