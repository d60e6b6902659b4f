"""IP: the program's counted host reads (``hqp_tpu_torch.utils.sync.COUNT``)
over the window, per IP iteration (a batch's step counts once)."""


def read(ctx):
    if not ctx["window_ip"]:
        return None
    return ctx["syncs"] / ctx["window_ip"]
