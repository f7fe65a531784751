"""Host tier: seconds in ``serve.fault_in`` (touch, staging, demand jobs,
the upload and the scatter of this step's missing pages) per engine step
of the window, in ms (program span)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    if w is None:
        return None
    return w["spans"].get("serve.fault_in", 0.0) / w["steps"] * 1e3
