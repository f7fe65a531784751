"""Engine loop: seconds in ``serve.admit`` (the admission round: candidate
picks, allocations with preemption, resumes and prefills) per engine step
of the window, in ms (program span)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    if w is None:
        return None
    return w["spans"].get("serve.admit", 0.0) / w["steps"] * 1e3
