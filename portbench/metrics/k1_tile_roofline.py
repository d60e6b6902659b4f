"""Kernels: K1's tile route (``csrc/gj_interior.cu``, one interior an SM)
against its roofline in the profiled unit: the least time the card needs
for the interior factorizations the unit's QPs needed
(``portbench.core.work.gj_bound_s`` at the cell's P, s, b, once a
factorization) over the device time of the kernels this metric's data
file names.  Its pattern names the tile kernel's template and not the
batched route's ``gj_interior_kernel_batched``."""

from portbench.core import spec, work


def read(ctx):
    tr, tt = ctx["trace"], ctx["trace_tally"]
    data = spec.metric_data("k1_tile_roofline")
    if tr is None or not tt:
        return None
    secs, _ = tr.device_seconds(data["kernels"])
    if secs <= 0:
        return None
    z = ctx["sizes"]
    need, _ = work.gj_bound_s(z["P"], z["s"], z["b"], data["dtype"])
    return 100.0 * need * tt["factorizations"] / secs
