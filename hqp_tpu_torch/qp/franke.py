"""Franke path-following interior-point QP solver.

Port of ``hqp_tpu/qp/franke.py`` (reference: hqp/Hqp_IpsFranke.C; Franke's
1994 diploma thesis; Wright, JOTA 1993): an embedding path-following
method that scales the initial KKT residuals (a1, a2, a3) by a homotopy
parameter zeta driven to zero together with the duality gap:

* cold start from x = 0 with the Wright/mu0 'Ltilde' slack shift
  (C:157-203),
* one corrector per iteration with mu from a potential-reduction /
  centering blend controlled by the averaged step length alphabar and
  rho_min (C:278-288),
* fraction-to-boundary step with beta = 0.995 (C:311-334),
* rho_min doubling/halving (C:338-343),
* termination: zeta < eps, gap < eps and solve residual < eps
  (C:363-375), with the hot-start fallback to a cold start (C:379-418).

Same backend interface as :class:`~hqp_tpu_torch.qp.mehrotra.Mehrotra`;
registered as ``sqp_qp_solver Franke``.  The solve loop runs on the host
and reads one stacked [iter, gap, result] vector per step.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from hqp_tpu_torch.qp import kkt as K_
from hqp_tpu_torch.qp import mehrotra as ipm
from hqp_tpu_torch.qp.mehrotra import (DEGENERATE, FEASIBLE, INFEASIBLE,
                                       ITERATING, OPTIMAL, SUBOPTIMAL,
                                       IPState)
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host


@dataclasses.dataclass
class FrankeState:
    ip: IPState
    a1: torch.Tensor
    a2: object
    a3: object
    zeta: torch.Tensor
    alphabar: torch.Tensor
    rhomin: torch.Tensor
    residuum: torch.Tensor

    # the SQP layer reads either IP solver's state through these
    @property
    def x(self):
        return self.ip.x

    @property
    def y(self):
        return self.ip.y

    @property
    def z(self):
        return self.ip.z

    @property
    def w(self):
        return self.ip.w

    @property
    def result(self):
        return self.ip.result

    @property
    def iter(self):
        return self.ip.iter


class Franke:
    """Franke path-following IP solver (module name 'Franke')."""

    def __init__(self, backend=None, eps=1e-9, max_iters=50,
                 max_warm_iters=15, beta=0.995, mu0=0.0):
        self.backend = backend
        self.eps = eps
        self.max_iters = max_iters
        self.max_warm_iters = max_warm_iters
        self.beta = beta
        self.mu0 = mu0

    def with_backend(self, backend):
        """A solver with ``backend`` bound (a copy if it differs)."""
        if backend is self.backend:
            return self
        new = copy.copy(self)
        new.backend = backend
        return new

    @staticmethod
    def _scalar(v, like):
        return torch.full((), v, dtype=torch.float64, device=like.device)

    def init_state(self, qp):
        base = ipm.Mehrotra(backend=self.backend,
                            max_iters=self.max_iters).init_state(qp)
        one = self._scalar(1.0, qp.c)
        return FrankeState(
            ip=base, a1=torch.zeros_like(qp.c),
            a2=mk.fill(qp.eq_offsets(), 0.0),
            a3=mk.fill(qp.ineq_mask(), 0.0),
            zeta=one, alphabar=one, rhomin=one,
            residuum=self._scalar(float("inf"), qp.c))

    @staticmethod
    def _restart(ip):
        """Iteration 0, ITERATING and a unit step length."""
        return dict(iter=torch.zeros_like(ip.iter),
                    result=torch.full_like(ip.result, ITERATING),
                    alpha=torch.ones_like(ip.alpha))

    # -- cold start (C:157-220) ----------------------------------------------

    def cold_start(self, qp, state: FrankeState):
        mask = qp.ineq_mask()
        m = mk.count(mask)
        d = qp.ineq_offsets()
        rhomin = 1000.0 * m
        min_d = mk.vmin(d, mask)
        if self.mu0 > 0:
            mean_d_h = 0.5 * mk.total(d, mask) / m
            Lt = -mean_d_h + torch.sqrt(mean_d_h ** 2
                                        + m * rhomin * self.mu0)
            Lt = torch.maximum(Lt, -min_d)
        else:
            Lt = torch.maximum(mk.norm_inf(d, mask), -min_d)
            Lt = torch.maximum(Lt, 1e2 * m)

        z0 = Lt / (m * m)
        z = mk.tmap(lambda mi: torch.where(mi, z0, 1.0), mask)
        w = mk.where(mask, mk.tmap(lambda di: Lt + di + 1e-10, d), 1.0)
        a1 = torch.where(qp.x_mask(),
                         qp.c - qp.matvec_ineqT(mk.where(mask, z, 0.0)), 0.0)
        a2 = mk.scale(-1.0, qp.eq_offsets())
        a3 = mk.tmap(lambda mi: torch.where(mi, Lt, 0.0), mask)

        ip = dataclasses.replace(
            state.ip, x=qp.zero_x(), y=mk.fill(qp.eq_offsets(), 0.0), z=z,
            w=w, gap=mk.inner(z, w, mask), **self._restart(state.ip))
        one = torch.ones_like(Lt)
        return FrankeState(ip=ip, a1=a1, a2=a2, a3=a3, zeta=one,
                           alphabar=one, rhomin=rhomin,
                           residuum=torch.full_like(Lt, float("inf")))

    # -- hot start (C:226-268) -----------------------------------------------

    def hot_start(self, qp, state: FrankeState):
        mask = qp.ineq_mask()
        ip = state.ip
        x, y, z = ip.x, ip.y, ip.z
        w = mk.where(mask, mk.tmap(lambda wi: wi + 1e-10, ip.w), 1.0)
        a1 = torch.where(
            qp.x_mask(),
            qp.matvec_Q(x) + qp.c - qp.matvec_eqT(y)
            - qp.matvec_ineqT(mk.where(mask, z, 0.0)), 0.0)
        a2 = mk.scale(-1.0, qp.eval_eq(x))
        a3 = mk.where(mask, mk.scale(-1.0, mk.sub(qp.eval_ineq(x), w)), 0.0)
        ip = dataclasses.replace(ip, w=w, gap=mk.inner(z, w, mask) + 1.0,
                                 **self._restart(ip))
        one = torch.ones_like(state.zeta)
        return dataclasses.replace(state, ip=ip, a1=a1, a2=a2, a3=a3,
                                   zeta=one, alphabar=one)

    # -- one path-following step (C:271-377) ---------------------------------

    def step(self, qp, state: FrankeState) -> FrankeState:
        eps = self.eps
        mask = qp.ineq_mask()
        m = mk.count(mask)
        ip = state.ip
        x, y, z, w = ip.x, ip.y, ip.z, ip.w
        gap, zeta = ip.gap, state.zeta
        alphabar = torch.where(ip.iter == 0, 1.0, state.alphabar)
        rhomin = state.rhomin

        mu = torch.where(
            (1.0 / gap < rhomin) | (ip.alpha < 1.0),
            alphabar * gap / rhomin + (1.0 - alphabar) * gap / m,
            gap * gap)

        r1 = -zeta * state.a1
        r2 = mk.scale(-zeta, state.a2)
        r3 = mk.where(mask, mk.scale(-zeta, state.a3), 0.0)
        r4 = mk.where(mask, mk.tmap(lambda zi, wi: zi * wi - mu, z, w), 0.0)

        fac = self.backend.factor(qp, z, w, mask)
        dx, dy, dz, dw = self.backend.solve(fac, qp, z, w, mask,
                                            r1, r2, r3, r4)

        # fraction to boundary; the steps are SUBTRACTED, so blocking
        # needs dz > 0: min z/dz over dz > 0 (C:311-334)
        val = torch.minimum(mk.ratio_min(z, mk.scale(-1.0, dz), mask),
                            mk.ratio_min(w, mk.scale(-1.0, dw), mask))
        alpha = torch.clamp(self.beta * val, max=1.0)

        alphabar = 0.5 * alphabar + 0.5 * alpha
        rhomin = torch.where(alphabar == 1.0, rhomin * 2.0,
                             torch.where((alphabar < 0.5)
                                         & (rhomin > 100.0 * m),
                                         rhomin / 2.0, rhomin))

        x_n = x - alpha * dx
        y_n = mk.axpy(-alpha, dy, y)
        z_n = mk.where(mask, mk.axpy(-alpha, dz, z), 1.0)
        w_n = mk.where(mask, mk.axpy(-alpha, dw, w), 1.0)
        zeta_n = zeta * (1.0 - alpha)
        gap_n = mk.inner(z_n, w_n, mask)

        bad = ~(torch.isfinite(gap_n) & torch.isfinite(mk.norm_inf(dx)))

        # residual of the solve, for the termination test
        *_, res = K_.kkt_residual(qp, z, w, mask, r1, r2, r3, r4,
                                  dx, dy, dz, dw)

        result = torch.where(
            bad, DEGENERATE,
            torch.where(~(zeta_n < eps),
                        torch.where(alpha < eps, SUBOPTIMAL, INFEASIBLE),
                        torch.where(~(gap_n < eps) | ~(res < eps),
                                    FEASIBLE, OPTIMAL)))

        def sel(a, b):
            return mk.tmap(lambda ai, bi: torch.where(bad, ai, bi), a, b)

        ip = dataclasses.replace(
            ip, x=torch.where(bad, x, x_n), y=sel(y, y_n), z=sel(z, z_n),
            w=sel(w, w_n), gap=torch.where(bad, gap, gap_n), alpha=alpha,
            iter=ip.iter + (~bad).to(ip.iter.dtype), result=result)
        return dataclasses.replace(state, ip=ip,
                                   zeta=torch.where(bad, zeta, zeta_n),
                                   alphabar=alphabar, rhomin=rhomin,
                                   residuum=res)

    # -- solve loop with the hot-start fallback (C:380-418) ------------------

    def solve(self, qp, state, hot: bool = False):
        fail_iters = 0
        state = self.hot_start(qp, state) if hot \
            else self.cold_start(qp, state)
        hot_started = hot
        gap1 = None
        while True:
            while True:
                state = self.step(qp, state)
                it, gap, res = host(torch.stack([
                    state.ip.iter.to(torch.float64), state.ip.gap,
                    state.ip.result.to(torch.float64)]))
                it, res = int(it), int(res)
                if hot_started:
                    if it == 1:
                        gap1 = gap
                    elif gap1 is not None and gap > gap1:
                        fail_iters += it
                        state = self.cold_start(qp, state)
                        hot_started = False
                        continue
                if it + fail_iters >= self.max_iters:
                    break
                if hot_started and it >= self.max_warm_iters:
                    break
                if res in (OPTIMAL, SUBOPTIMAL, DEGENERATE):
                    break
            if hot_started and res != OPTIMAL:
                fail_iters += it
                state = self.cold_start(qp, state)
                hot_started = False
            else:
                break
        ip = dataclasses.replace(state.ip, iter=state.ip.iter + fail_iters)
        return dataclasses.replace(state, ip=ip)


modules.register("sqp_qp_solver", "Franke")(Franke)
