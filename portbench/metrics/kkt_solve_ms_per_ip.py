"""KKT: milliseconds in the KKT backend's solve (its refinement rounds
included), by synchronizing spans, per IP iteration of the spanned part
(the cold start's solve included)."""


def read(ctx):
    sp, st = ctx["spans"], ctx["span_tally"]
    if sp is None or not st or not st["ip"] or not sp.calls["kkt.solve"]:
        return None
    return 1e3 * sp.excl["kkt.solve"] / st["ip"]
