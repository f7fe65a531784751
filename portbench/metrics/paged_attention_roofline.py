"""Kernels: decode attention's least time (every attended token's KV bytes,
as the configuration defines them, at the HBM peak) over the paged
kernels' device time in the traced slice, in %."""


def read(r):
    t = r.get("trace")
    if not t or not t["paged_kernel_s"] or not t["paged_least_s"]:
        return None
    return t["paged_least_s"] / t["paged_kernel_s"] * 100
