"""QP presolve: merge near-parallel general rows into box bounds.

Port of ``hqp_tpu/qp/presolve.py``.  A general row whose off-axis mass is
below ``tau`` relative to its dominant coefficient (the DID's
discretization-shifted path row ``x1 + (dt/2) x0 <= 0.01`` beside the box
row ``x1 <= 0.01``, hqp_docp/Prg_DID.C:55-58) makes the active Jacobian
lose rank along a whole arc of stages, and a pure path-following method
pinches there.  :func:`merge_parallel_rows` folds such rows into the
dominant variable's box bound and deactivates them: exact for true
duplicates, and otherwise a change of the feasible set by at most
``tau * |c_i| * max_j |v_j|`` per merged row, which
:func:`original_row_violation` measures at a solution.

Both take a StageQP with or without leading batch axes.
"""

from __future__ import annotations

import dataclasses

import torch

from hqp_tpu_torch.qp.program import StageQP
from hqp_tpu_torch.utils import log


@log.spanned("presolve.merge")
def merge_parallel_rows(qp: StageQP, tau: float = 0.02) -> StageQP:
    """Fold tau-parallel general rows into box bounds (see module doc)."""
    if qp.mc == 0:
        return qp
    C = qp.C
    absC = C.abs()
    imax = torch.argmax(absC, dim=-1)                 # [..., K1, mc]
    cmax = absC.gather(-1, imax[..., None])[..., 0]
    rest = absC.sum(-1) - cmax
    par = (cmax > 0.0) & (rest <= tau * cmax) & qp.con_mask

    lb, ub = qp.lb, qp.ub
    d_lo, d_up = qp.d_lo.clone(), qp.d_up.clone()
    cols = torch.arange(qp.nv, device=C.device)
    for e in range(qp.mc):
        i = imax[..., e]                               # [..., K1]
        hot = cols == i[..., None]                     # [..., K1, nv]
        ci = C[..., e, :].gather(-1, i[..., None])[..., 0]
        pe = par[..., e]
        csafe = torch.where(ci == 0.0, 1.0, ci)

        up = qp.d_up[..., e]
        fin_up = torch.isfinite(up) & pe
        vup = (up / csafe)[..., None]
        # ci > 0: v_i <= d/ci tightens ub; ci < 0: v_i >= d/ci tightens lb
        ub = torch.where(hot & (fin_up & (ci > 0.0))[..., None],
                         torch.minimum(ub, vup), ub)
        lb = torch.where(hot & (fin_up & (ci < 0.0))[..., None],
                         torch.maximum(lb, vup), lb)

        lo = qp.d_lo[..., e]
        fin_lo = torch.isfinite(lo) & pe
        vlo = (lo / csafe)[..., None]
        lb = torch.where(hot & (fin_lo & (ci > 0.0))[..., None],
                         torch.maximum(lb, vlo), lb)
        ub = torch.where(hot & (fin_lo & (ci < 0.0))[..., None],
                         torch.minimum(ub, vlo), ub)

        d_up[..., e] = torch.where(pe, float("inf"), d_up[..., e])
        d_lo[..., e] = torch.where(pe, float("-inf"), d_lo[..., e])

    return dataclasses.replace(qp, lb=lb, ub=ub, d_lo=d_lo, d_up=d_up)


@log.spanned("presolve.violation")
def original_row_violation(qp: StageQP, x) -> torch.Tensor:
    """Largest violation of the ORIGINAL general rows of ``qp`` at ``x``
    (the honesty measure reported beside presolved solves); one per
    problem of a batch."""
    lead = qp.batch_shape
    if qp.mc == 0:
        return torch.zeros(lead, dtype=x.dtype, device=x.device)
    Cv = torch.einsum("...kij,...kj->...ki", qp.C, x)
    up = torch.where(torch.isfinite(qp.d_up) & qp.con_mask,
                     Cv - qp.d_up, float("-inf"))
    lo = torch.where(torch.isfinite(qp.d_lo) & qp.con_mask,
                     qp.d_lo - Cv, float("-inf"))
    worst = torch.maximum(up, lo).reshape(lead + (-1,)).amax(-1)
    return torch.clamp(worst, min=0.0)
