"""Manager: seconds in ``serve.preempt`` (swapping a victim out: the
gather, its copy to the host, the host store and the frees), wherever
called, per engine step of the window, in ms (program span)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    if w is None:
        return None
    return w["spans"].get("serve.preempt", 0.0) / w["steps"] * 1e3
