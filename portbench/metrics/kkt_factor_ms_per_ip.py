"""KKT: milliseconds in the KKT backend's factor (exclusive of the spans
it calls), by synchronizing spans, per IP iteration of the spanned
part (the cold start's factorization included)."""


def read(ctx):
    sp, st = ctx["spans"], ctx["span_tally"]
    if sp is None or not st or not st["ip"] or not sp.calls["kkt.factor"]:
        return None
    return 1e3 * sp.excl["kkt.factor"] / st["ip"]
