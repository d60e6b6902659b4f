"""IP: device operations (kernels, copies, sets) in the profiled unit,
per IP iteration of that unit (a batch's step counts once)."""


def read(ctx):
    tr, tt = ctx["trace"], ctx["trace_tally"]
    if tr is None or not tt or not tt["ip"]:
        return None
    return tr.events / tt["ip"]
