"""Manager: the pool's coalesced fraction (pages in frames the coalescer
has made large pages: the paper's TLB reach) as each decoding step reads
it, averaged over those steps of the window, in % (program counter)."""

from portbench.lib.steplog import window


def read(r):
    w = window(r)
    n = None if w is None else w["records_with"].get("coalesced_fraction")
    if not n:
        return None
    return w["counters"]["coalesced_fraction"] / n * 100
