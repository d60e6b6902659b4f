"""Device: the most memory the caching allocator held for tensors during
the window (``torch.cuda.max_memory_allocated`` after a reset at its
start), in GiB."""


def read(ctx):
    if not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2.0 ** 30
