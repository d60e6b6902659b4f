"""Least-squares multiplier start.

Port of ``est_y`` and ``_lin_eq`` of ``hqp_tpu/utils/diagnostics.py``
(the rest of that module is not ported yet).
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.utils import masked as mk


def _lin_eq(qp, d):
    """Linear part of the equality rows applied to d."""
    e1 = qp.eval_eq(qp.zero_x() + d)
    e0 = qp.eval_eq(qp.zero_x())
    return mk.sub(e1, e0)


def est_y(qp, g=None, iters: int = 40, reg: float = 1e-10):
    """Least-squares equality multipliers argmin_y ||g - J'y||^2 by
    ``iters`` conjugate-gradient steps on (J J' + reg) y = J g, J the
    equality-row operator (dynamics, fixed and general stage rows of a
    StageQP; the A rows of a DenseQP); g defaults to the QP gradient c.

    Role of Hqp_HL::est_y (hqp/Hqp_HL.C), the multiplier start of a hela
    with ``init_multipliers``.  The loop has a fixed length and reads
    nothing back."""
    if g is None:
        g = qp.c
    emask = qp.eq_mask()
    xmask = qp.x_mask()

    def J(v):
        return _lin_eq(qp, torch.where(xmask, v, 0.0))

    def JT(y):
        return torch.where(xmask, qp.matvec_eqT(mk.where(emask, y, 0.0)),
                           0.0)

    def Aop(y):
        return mk.tmap(lambda a, b: a + reg * b, J(JT(y)), y)

    b = J(torch.where(xmask, g, 0.0))
    y = mk.fill(qp.eq_offsets(), 0.0)
    r = mk.where(emask, mk.sub(b, Aop(y)), 0.0)
    p = r
    rs = mk.inner(r, r, emask)
    for _ in range(iters):
        Ap = mk.where(emask, Aop(p), 0.0)
        denom = mk.inner(p, Ap, emask)
        alpha = torch.where(denom > 0.0,
                            rs / torch.clamp(denom, min=1e-300), 0.0)
        y = mk.axpy(alpha, p, y)
        r = mk.axpy(-alpha, Ap, r)
        rs_new = mk.inner(r, r, emask)
        beta = torch.where(rs > 0.0, rs_new / torch.clamp(rs, min=1e-300),
                           0.0)
        p = mk.axpy(beta, p, r)
        rs = rs_new
    return mk.where(emask, y, 0.0)
