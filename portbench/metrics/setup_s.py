"""Seconds from the start of the run's process to the window: imports,
the card's start, the kernels' build or load, the program's set-up, the
draws and one warm unit (host clock)."""


def read(ctx):
    return ctx["setup_s"]
