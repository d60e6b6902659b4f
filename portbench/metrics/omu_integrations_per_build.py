"""QP build: the integrator's calls per batched QP build over the run
(set-up's warm unit and the window: a run is a process of its own, and
the counters count from import), from the program's counters
``hqp_tpu_torch.omu.program.INTEGRATIONS`` and
``hqp_tpu_torch.docp.program.QP_BUILDS``.  Under ``vmap`` one call
integrates a sample period of every stage, so a build that integrates
once for the values and once more for the derivatives reads 2.  None
where the program has no such counters or built no QP."""

from hqp_tpu_torch.docp import program as docp
from hqp_tpu_torch.omu import program as omu


def read(ctx):
    calls = getattr(omu, "INTEGRATIONS", None)
    builds = getattr(docp, "QP_BUILDS", 0)
    if calls is None or not builds:
        return None
    return calls / builds
