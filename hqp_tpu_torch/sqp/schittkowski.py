"""Schittkowski SQP globalization: augmented-Lagrangian line search.

Port of ``hqp_tpu/sqp/schittkowski.py`` (reference:
hqp/Hqp_SqpSchittkowski.C).  The merit function is Schittkowski's
augmented Lagrangian over (x, multiplier iterates v):

  phi = f - sum_J [v_i g_i - r_i g_i^2 / 2] - sum_K [v_i^2 / (2 r_i)]

with the index set J (g <= v/r) and K for inequalities; penalties
r_i = max(sgm_i r_i, 2m (u_i - v_i)^2 / dQd) (update_r, C:135-161) with
forgetting factors sgm_i = min(1, iter/sqrt(r_i)) (update_sgm,
C:115-132); the search direction in multiplier space is u - v, and the
line search takes mu = 0.1 Armijo with beta = 0.1 backtracking and the
quadratic lower bound (C:262-324).  Multipliers are damped along the step
by default (C:59).
"""

from __future__ import annotations

import math

import torch

from hqp_tpu_torch.sqp.solver import SqpSolver
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host


def _phi_s(f, qp, ve, v, re, r):
    """Augmented-Lagrangian merit (Hqp_SqpSchittkowski::phi, C:164-198)."""
    b = qp.eq_offsets()
    pen_e = mk.total(mk.tmap(lambda vi, ri, g: -(vi * g - 0.5 * ri * g * g),
                             ve, re, b), qp.eq_mask()) \
        if mk.tsize(b) else 0.0
    d = qp.eval_ineq(qp.zero_x())

    def leaf(vi, ri, g):
        return torch.where(g <= vi / ri, -(vi * g - 0.5 * ri * g * g),
                           -0.5 * vi * vi / ri)

    pen_i = mk.total(mk.tmap(leaf, v, r, d), qp.ineq_mask())
    return f + pen_e + pen_i


def _dphi_s(qp, s, ve, v, re, r, ue_ve, u_v):
    """Directional derivative of the merit at the current point along
    (s, u - v) (Hqp_SqpSchittkowski::dphi, C:200-259)."""
    mask = qp.ineq_mask()
    b = qp.eq_offsets()
    d = qp.eval_ineq(qp.zero_x())

    # d phi / d x  =  c - A'(ve - re*b) - C'_J (v - r*d)
    vrg_e = mk.tmap(lambda vi, ri, g: vi - ri * g, ve, re, b)
    inJ = mk.tmap(lambda vi, ri, g: g <= vi / ri, v, r, d)
    vrg_i = mk.tmap(lambda m, vi, ri, g: torch.where(m, vi - ri * g, 0.0),
                    inJ, v, r, d)
    phix = qp.c - qp.matvec_eqT(vrg_e) - qp.matvec_ineqT(vrg_i)

    # d phi / d ve = -b ;  d phi / d v = -g (J) or -v/r (K)
    phiv = mk.tmap(lambda m, vi, ri, g: torch.where(m, -g, -vi / ri),
                   inJ, v, r, d)

    ret = mk.inner(phix, s)
    if mk.tsize(b):
        ret = ret + mk.inner(mk.scale(-1.0, b), ue_ve, qp.eq_mask())
    return ret + mk.inner(phiv, u_v, mask)


@modules.register("sqp_solver", "Schittkowski")
class SqpSchittkowski(SqpSolver):
    name = "Schittkowski"

    def __init__(self, prg, mu=0.1, beta=0.1, damped_multipliers=True, **kw):
        super().__init__(prg, **kw)
        self.mu = mu
        self.beta = beta
        self.damped_multipliers = damped_multipliers

    def subclass_init(self):
        self.re = mk.fill(self.qp.eq_offsets(), 1.0)
        self.r = mk.fill(self.z, 1.0)
        self.ve = mk.fill(self.re, 0.0)
        self.v = mk.fill(self.z, 0.0)

    def _update_sgm(self, r):
        return mk.tmap(
            lambda ri: torch.clamp(self.iter / torch.sqrt(ri), max=1.0), r)

    @staticmethod
    def _update_r(u, v, sgm, dQd, r, m2):
        def leaf(ui, vi, si, ri):
            val1 = si * ri
            uv = ui - vi
            val2 = m2 * uv * uv / dQd
            return torch.where(val2 > val1, val2, val1)  # NaN-safe as ref

        return mk.tmap(leaf, u, v, sgm, r)

    def update_vals(self):
        qp = self.qp
        eps = self.eps
        me = (mk.count(qp.eq_mask()) if mk.tsize(qp.eq_offsets())
              else torch.zeros((), dtype=torch.float64, device=qp.device))
        m2 = 2.0 * (me + mk.count(qp.ineq_mask()))
        dQd = max(self.sQs, 1e-30)

        sgme = self._update_sgm(self.re)
        sgm = self._update_sgm(self.r)
        self.y = self.ip_state.y
        self.z = self.ip_state.z
        self.re = self._update_r(self.y, self.ve, sgme, dQd, self.re, m2)
        self.r = self._update_r(self.z, self.v, sgm, dQd, self.r, m2)

        ue_ve = mk.sub(self.y, self.ve)
        u_v = mk.sub(self.z, self.v)

        x0 = self.x
        qp0 = qp
        ve0, v0 = self.ve, self.v
        phi0, dphi0 = host(torch.stack([
            _phi_s(self.f, qp, self.ve, self.v, self.re, self.r),
            _dphi_s(qp, self.s, self.ve, self.v, self.re, self.r, ue_ve,
                    u_v)]))

        alpha = self.min_alpha if dphi0 > 0.0 else 1.0
        while True:
            xk = x0 + alpha * self.s
            self.ve = mk.axpy(alpha, ue_ve, ve0)
            self.v = mk.axpy(alpha, u_v, v0)
            if self.damped_multipliers and alpha < 1.0:
                self.y = self.ve
                self.z = self.v
            f, qpv = self.prg.update_fbd_qp(qp0, x0, xk)
            self.x, self.f, self.qp = xk, f, qpv
            fv, phik = host(torch.stack(
                [f, _phi_s(f, qpv, self.ve, self.v, self.re, self.r)]))
            if not math.isfinite(fv):
                alpha *= 0.1
                continue
            if alpha <= self.min_alpha:
                break
            if phik <= phi0 + self.mu * alpha * dphi0 or abs(dphi0) <= eps:
                break
            n_alpha = 0.5 * dphi0 * alpha * alpha / \
                (dphi0 * alpha - (phik - phi0))
            if not (n_alpha < alpha):
                break
            alpha = max(alpha * self.beta, n_alpha)

        self.alpha = alpha
        self.d = alpha * self.s
        self.dphi = dphi0
        self.phi = phi0
