"""QP build: milliseconds a unit of work (a batch of QPs) spends in the
program's make_qp_batch and its presolve, by synchronizing
spans, in the traced run's spanned part."""


def read(ctx):
    sp = ctx["spans"]
    if sp is None or not ctx["span_units"] or not sp.calls["qp_build"]:
        return None
    return 1e3 * sp.excl["qp_build"] / ctx["span_units"]
