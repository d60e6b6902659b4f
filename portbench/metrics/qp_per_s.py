"""QPs solved to the cell's tolerance in the window, over the window's
seconds (host clock; the window ends with the first unit that ends after
``--seconds``, so every unit in it is whole)."""


def read(ctx):
    return (ctx["attempted"] - ctx["failed"]) / ctx["window_s"]
