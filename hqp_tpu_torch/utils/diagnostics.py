"""Diagnostics: derivative checker, QP dumps, multiplier estimate.

Port of ``hqp_tpu/utils/diagnostics.py``:

* :func:`prg_test` -- finite-difference check of a program's first
  derivatives at an iterate, the role of ``Hqp_SqpProgram::test`` exposed
  as the Tcl command ``prg_test`` (hqp/Hqp_SqpProgram.C:116-186).
* :func:`qp_dump` / :func:`qp_load` -- a QP linearization as an ``.npz``
  of its fields (``Hqp_SqpProgram::qp_dump``, hqp/Hqp_SqpProgram.C:188).
  The file holds a plain ``__type__`` and one array per field, as the
  reference package writes it, so a QP dumped by either package loads
  into either.
* :func:`est_y` -- least-squares equality multipliers (``Hqp_HL::est_y``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.sync import host, to_host


# ---------------------------------------------------------------------------
# prg_test: finite-difference derivative checking
# ---------------------------------------------------------------------------

def prg_test(prg, v=None, n_probe: int = 8, h: float = 1e-6,
             tol: float = 1e-4, seed: int = 0):
    """Check the program's derivatives against central differences along
    ``n_probe`` random directions, drawn from ``np.random.default_rng(seed)``
    as the reference package draws them (so both probe the same ones).

    Returns a dict {max_rel_err, probes, ok}; raises ValueError above
    ``tol`` like the reference's ``error`` return.  The relative errors
    are computed on the QP's device and read back once."""
    if v is None:
        v = prg.setup()
    _, qp0 = prg.make_qp(v)
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(n_probe):
        d = rng.standard_normal(tuple(v.shape))
        d = torch.as_tensor(d / (np.linalg.norm(d.ravel()) + 1e-300),
                            dtype=v.dtype, device=v.device)
        fp, qpp = prg.update_fbd_qp(qp0, v, v + h * d)
        fm, qpm = prg.update_fbd_qp(qp0, v, v - h * d)

        # objective gradient: c'd vs (f(v+hd) - f(v-hd)) / 2h
        errs.append(_rel(mk.inner(qp0.c, d), (fp - fm) / (2.0 * h)))

        # equality rows: J d vs FD of the residual values at the iterate
        z0 = qp0.zero_x()
        fd_e = mk.tmap(lambda a, b: (a - b) / (2.0 * h),
                       qpp.eval_eq(z0), qpm.eval_eq(z0))
        errs.append(_tree_rel(_lin_eq(qp0, d), fd_e, qp0.eq_mask()))

        # inequality rows: group VALUES at the iterate (their per-group
        # signs match matvec_ineq's convention; raw offsets do not)
        fd_i = mk.tmap(lambda a, b: (a - b) / (2.0 * h),
                       qpp.eval_ineq(z0), qpm.eval_ineq(z0))
        errs.append(_tree_rel(qp0.matvec_ineq(d), fd_i, qp0.ineq_mask()))

    max_err = max(host(torch.stack(errs)))
    out = {"max_rel_err": max_err, "probes": n_probe, "ok": max_err < tol}
    if not out["ok"]:
        raise ValueError(
            f"prg_test: derivative check failed, max relative error "
            f"{max_err:.3e} > {tol:.1e} (Hqp_SqpProgram::test role)")
    return out


def _rel(a, b, floor=1e-6):
    """|a - b| / max(|a|, |b|, floor) of two scalars, on their device."""
    den = torch.clamp(torch.maximum(a.abs(), b.abs()), min=floor)
    return (a - b).abs() / den


def _tree_rel(an, fd, mask, floor=1e-6):
    num = mk.norm_inf(mk.sub(an, fd), mask)
    den = torch.clamp(torch.maximum(mk.norm_inf(an, mask),
                                    mk.norm_inf(fd, mask)), min=floor)
    return num / den


# ---------------------------------------------------------------------------
# qp_dump / qp_load
# ---------------------------------------------------------------------------

def qp_dump(qp, path: str):
    """Write every present field of the QP dataclass to an ``.npz``
    (one counted host copy a field)."""
    fields = {fl.name: to_host(getattr(qp, fl.name))
              for fl in dataclasses.fields(qp)
              if getattr(qp, fl.name) is not None}
    np.savez(path, __type__=type(qp).__name__, **fields)


def qp_load(path: str, device="cuda"):
    """Re-create a dumped QP (written by either package) on ``device``:
    floating fields as float64, masks as bool."""
    from hqp_tpu_torch import convert
    from hqp_tpu_torch.qp import program as qprog
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    cls = getattr(qprog, str(data.pop("__type__")))
    return cls(**{k: convert.tensor(v, device) for k, v in data.items()})


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
