"""Whether the timed path's answers are correct.

Every unit of the window is judged, once the window has closed, by the
configuration's plain reference: it builds each draw's QP again from the
model's equations (``build_qp``), presolves it by its own copy of the
rule, and judges the program's answer for every QP by the optimality
certificate of :mod:`portbench.reference.stageqp` on that QP.  The
original rows' violations the program returned are compared with the
reference's at the program's x.

The numbers, each the worst over every QP of the window, and their
limits (the configuration's ``limits``):

- ``not_optimal``: QPs the program did not report optimal (limit 0);
- ``primal``, ``dual``, ``mu``: the certificate (the configuration's
  tolerance ``eps`` is the limit of each: its interior point stops there);
- ``viol_gap``: the largest gap of an original-row violation.

A QP fails where any of its numbers passes its limit; ``failed`` counts
them.
"""

from __future__ import annotations

import torch

from portbench.reference import stageqp


def judge(ref, cfg, units, outputs, Q):
    """(numbers, attempted, failed): ``numbers`` maps each compared
    quantity to {"value", "limit"}; ``outputs(unit)`` is the program's
    answer as plain tensors, ``Q`` the Hessian the units were given."""
    lim = cfg["limits"]
    tau = float(cfg["presolve_tau"])
    worst = {"not_optimal": 0, "primal": 0.0, "dual": 0.0, "mu": 0.0,
             "viol_gap": 0.0}
    attempted = failed = 0
    for unit in units:
        out = outputs(unit)
        with torch.no_grad():
            rq = ref.build_qp(cfg, unit.v, Q)
            rqs = stageqp.presolve(rq, tau)
            primal, dual, mu = stageqp.certificate(
                rqs, out["x"], out["y"], out["z"], out["w"])
        bad = ~out["optimal"] | ~(primal <= lim["primal"]) \
            | ~(dual <= lim["dual"]) | ~(mu <= lim["mu"])
        worst["not_optimal"] += int((~out["optimal"]).sum())
        for key, t in (("primal", primal), ("dual", dual), ("mu", mu)):
            # NaN reads as inf: never under a limit
            t = torch.nan_to_num(t, nan=float("inf"))
            worst[key] = max(worst[key], float(t.max()))
        mine = stageqp.row_violation(rq, out["x"])
        vg = torch.nan_to_num((unit.viol - mine).abs(), nan=float("inf"))
        worst["viol_gap"] = max(worst["viol_gap"], float(vg.max()))
        bad = bad | ~(vg <= lim["viol_gap"])
        attempted += bad.numel()
        failed += int(bad.sum())
    numbers = {k: {"value": v, "limit": lim[k]} for k, v in worst.items()}
    return numbers, attempted, failed
