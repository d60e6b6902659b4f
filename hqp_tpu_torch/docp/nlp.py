"""General (unstructured) NLP programs over the dense QP path.

Port of ``hqp_tpu/docp/nlp.py`` (reference: the parse_constr buckets of
hqp/Hqp_Docp.C:368-444 and the general NLP front of Prg_CUTE.C).  A
program gives ``f0(x)`` and ``c(x)`` with two-sided bounds; setup sorts
the rows once into equality rows (min == max) and one-sided inequality
rows, and every linearization is a :class:`~hqp_tpu_torch.qp.program.
DenseQP` with that fixed row structure.  Derivatives come from
``torch.func.grad`` / ``jacrev`` / ``hessian``; write ``f0`` and ``c`` in
torch ops those can transform (``torch.stack``, not ``torch.tensor``).
Every program lives on one ``device``, the card unless the constructor is
given another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hqp_tpu_torch.docp.program import resolve_device
from hqp_tpu_torch.qp.program import DenseQP


class Nlp:
    """Subclass and override: n, m, setup_vars(), f0(x), c(x).

    Constraint convention (two-sided at the user level):
    c_min <= c(x) <= c_max, x_min <= x <= x_max; min == max rows become
    equality rows, as the reference's parse_constr buckets them.  A
    subclass constructor passes its ``device`` to ``Nlp.__init__``.
    """

    n: int = 0
    m: int = 0  # number of user constraint functions
    name = "Nlp"

    #: evaluation counters (prg_fbd_evals role)
    fbd_evals: int = 0
    grd_evals: int = 0

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def setup_vars(self):
        return {}

    def f0(self, x):
        raise NotImplementedError

    def c(self, x):
        return x.new_zeros((0,))

    # ------------------------------------------------------------------

    def setup(self):
        """Row buckets, bounds and the initial point, computed in host
        numpy and placed on the device once."""
        v = self.setup_vars()
        inf = np.inf

        def get(key, shape, default):
            a = v.get(key)
            if a is None:
                return np.full(shape, default, np.float64)
            return np.asarray(a, np.float64).reshape(shape)

        x_init = get("x_init", (self.n,), 0.0)
        x_min = get("x_min", (self.n,), -inf)
        x_max = get("x_max", (self.n,), inf)
        c_min = get("c_min", (self.m,), -inf)
        c_max = get("c_max", (self.m,), inf)

        def rows(a):
            return torch.as_tensor(np.where(a)[0], device=self.device)

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device)

        # static row structure (parse_constr analog)
        vfix = np.isfinite(x_min) & (x_min == x_max)
        vlb = np.isfinite(x_min) & (x_min != x_max)
        vub = np.isfinite(x_max) & (x_min != x_max)
        self._vfix, self._vlb, self._vub = rows(vfix), rows(vlb), rows(vub)
        self._cfix = rows(np.isfinite(c_min) & (c_min == c_max))
        self._clb = rows(np.isfinite(c_min) & (c_min != c_max))
        self._cub = rows(np.isfinite(c_max) & (c_min != c_max))
        self._x_min, self._x_max = t(x_min), t(x_max)
        self._c_min, self._c_max = t(c_min), t(c_max)
        # the constant rows of the variable bounds, built on the device
        eye = torch.eye(self.n, dtype=torch.float64, device=self.device)
        self._eye_fix, self._eye_lb = eye[self._vfix], eye[self._vlb]
        self._eye_ub = -eye[self._vub]

        x0 = np.clip(x_init, np.where(np.isfinite(x_min), x_min, -inf),
                     np.where(np.isfinite(x_max), x_max, inf))
        return t(x0)

    def _eval(self, x):
        f = self.f0(x)
        cv = torch.atleast_1d(self.c(x)) if self.m else x.new_zeros((0,))
        return f, cv

    def _derivs(self, x):
        g = torch.func.grad(self.f0)(x)
        J = (torch.func.jacrev(lambda xx: torch.atleast_1d(self.c(xx)))(x)
             if self.m else x.new_zeros((0, self.n)))
        return g, J

    def _offsets(self, x, cv):
        """The equality offsets b and the one-sided inequality offsets d
        at the values (x, cv)."""
        b = torch.cat([x[self._vfix] - self._x_min[self._vfix],
                       cv[self._cfix] - self._c_min[self._cfix]])
        d = torch.cat([x[self._vlb] - self._x_min[self._vlb],
                       self._x_max[self._vub] - x[self._vub],
                       cv[self._clb] - self._c_min[self._clb],
                       self._c_max[self._cub] - cv[self._cub]])
        return b, d

    def _rows(self, x, cv, J):
        """Equality and inequality rows from the values and Jacobian."""
        A = torch.cat([self._eye_fix, J[self._cfix]])
        C = torch.cat([self._eye_lb, self._eye_ub, J[self._clb],
                       -J[self._cub]])
        b, d = self._offsets(x, cv)
        return A, b, C, d

    def make_qp(self, x, Q=None):
        self.fbd_evals += 1
        self.grd_evals += 1
        f, cv = self._eval(x)
        g, J = self._derivs(x)
        A, b, C, d = self._rows(x, cv, J)
        if Q is None:
            Q = x.new_zeros((self.n, self.n))
        qp = DenseQP(
            Q=Q, c=g, A=A, b=b, C=C, d=d,
            eq_mask_=torch.ones(A.shape[0], dtype=torch.bool,
                                device=x.device),
            ineq_mask_=torch.ones(C.shape[0], dtype=torch.bool,
                                  device=x.device))
        return f, qp

    def update_fbd_qp(self, qp: DenseQP, x_old, x_new):
        """Fresh values, stale derivative rows (Hqp_SqpProgram::update_fbd):
        only the offsets b and d are recomputed."""
        self.fbd_evals += 1
        f, cv = self._eval(x_new)
        b, d = self._offsets(x_new, cv)
        return f, dataclasses.replace(qp, b=b, d=d)

    def eval_grd_L(self, x, y, z):
        """grad of the Lagrangian g - A'y - C'z at x, z a DenseIneq."""
        f, cv = self._eval(x)
        g, J = self._derivs(x)
        A, b, C, d = self._rows(x, cv, J)
        return g - A.T @ y - C.T @ z.g

    def eval_hess_blocks(self, x, y, z):
        """Exact Lagrangian Hessian as one block [1, n, n].  Variable-bound
        rows have zero curvature, so only the c-rows contribute."""
        nb = len(self._vlb) + len(self._vub)
        ncl = len(self._clb)
        yc = y[len(self._vfix):]
        zc_lo = z.g[nb:nb + ncl]
        zc_up = z.g[nb + ncl:]

        def lagr(xx):
            cv = (torch.atleast_1d(self.c(xx)) if self.m
                  else xx.new_zeros((0,)))
            val = self.f0(xx)
            val = val - yc @ cv[self._cfix]
            return val - zc_lo @ cv[self._clb] + zc_up @ cv[self._cub]

        return torch.func.hessian(lagr)(x)[None]

    def split_blocks(self, vec):
        return vec[None]

    def q_to_blocks(self, Q):
        return Q[None]

    def q_from_blocks(self, Qb):
        return Qb[0]
