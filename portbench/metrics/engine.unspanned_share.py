"""Engine loop: the share of ``serve.step`` that no phase span directly
under it covers, over the window, in % (program span)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    if w is None or not w["spans"].get("serve.step"):
        return None
    return (1.0 - sum(w["depth1"].values()) / w["spans"]["serve.step"]) \
        * 100
