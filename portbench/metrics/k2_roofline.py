"""Kernels: K2's share of its roofline in the profiled unit: the least
time the card needs for one master solve a KKT solve of the unit's QPs
(``portbench.core.work.thomas_bound_s`` at the cell's N, n) over the
device time of the kernels this metric's data file names.  Its bound
counts bytes and operations only; the kernel's floor is N dependent
steps, far above it."""

from portbench.core import spec, work


def read(ctx):
    tr, tt = ctx["trace"], ctx["trace_tally"]
    data = spec.metric_data("k2_roofline")
    if tr is None or not tt:
        return None
    secs, _ = tr.device_seconds(data["kernels"])
    if secs <= 0:
        return None
    z = ctx["sizes"]
    need, _ = work.thomas_bound_s(z["N"], z["n"], 1, data["dtype"])
    return 100.0 * need * tt["kkt_solves"] / secs
