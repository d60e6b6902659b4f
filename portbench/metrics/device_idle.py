"""Device: the share of the profiled unit's window in which no device
operation ran (torch.profiler)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
