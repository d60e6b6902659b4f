"""KKT: refinement rounds per refinement gate entered, over the run (set-up's
warm unit and the window), from the program's counters
``hqp_tpu_torch.qp.kkt.REFINE_ROUNDS`` and ``REFINE_CALLS`` (a batch's
round counts once, as its step does).  None where the program has no
such counters or entered no gate."""

from hqp_tpu_torch.qp import kkt


def read(ctx):
    rounds = getattr(kkt, "REFINE_ROUNDS", None)
    calls = getattr(kkt, "REFINE_CALLS", 0)
    if rounds is None or not calls:
        return None
    return rounds / calls
