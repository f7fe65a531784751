"""Manager: OutOfMemory-triggered passes that compacted every owner, per
engine step of the window (program counter, summed over sub-pools)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    if w is None:
        return None
    return w["counters"].get("oom_compactions", 0) / w["steps"]
