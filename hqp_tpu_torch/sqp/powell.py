"""Powell SQP globalization: exact penalty line search with watchdog.

Port of ``hqp_tpu/sqp/powell.py`` (reference: hqp/Hqp_SqpPowell.C):

* penalty update  r_i = |z_i|            on the first iteration,
                  r_i = max(|z_i|, (|z_i| + r_i)/2)  afterwards  (C:118-150),
* penalty function phi = f + re'|b| - r'min(0, d)   (C:189-210),
* predicted phi1 at the full QP step                (C:213-244),
* backtracking line search with the quadratic-interpolation lower bound
  n_alpha = 0.5 d0 a^2 / (d0 a - (phik - phi0))     (C:350-377),
* watchdog relaxation with backing store            (C:280-346),
* optionally damped multipliers                     (C:253-260, 353-356).
"""

from __future__ import annotations

import math

import torch

from hqp_tpu_torch.sqp.solver import SqpSolver, _phi, _phi1
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host


@modules.register("sqp_solver", "Powell")
class SqpPowell(SqpSolver):
    name = "Powell"

    def __init__(self, prg, watchdog_start=10, watchdog_credit=0,
                 damped_multipliers=False, **kw):
        super().__init__(prg, **kw)
        self.watchdog_start = watchdog_start
        self.watchdog_credit = watchdog_credit
        self.damped_multipliers = damped_multipliers
        self.re = None
        self.r = None

    def subclass_init(self):
        self.re = mk.fill(self.qp.eq_offsets(), 0.0)
        self.r = mk.fill(self.z, 0.0)
        self._relaxed = False
        self._watchdog_iter = -1
        self._phil = 0.0
        self._phil_test = 0.0
        self._wd_backup = None
        #: observability counters (Hqp_SqpPowell.C:280-346 logging)
        self.wd_relaxed_steps = 0
        self.wd_backouts = 0

    def _update_r(self, z, r):
        """Penalty coefficient update (Powell's rule, C:118-150)."""
        az = mk.tmap(torch.abs, z)
        if self.iter == 0:
            return az
        return mk.tmap(
            lambda a, ro: torch.where(a > ro, a, 0.5 * (a + ro)), az, r)

    def _phi_pair(self, qp):
        phi0, phi1 = host(torch.stack([
            _phi(self.f, qp, self.re, self.r),
            _phi1(self.f, qp, self.s, self.re, self.r)]))
        return phi0, phi1 - phi0

    def update_vals(self):
        eps = self.eps
        qp = self.qp

        # update penalties with the QP multipliers (C:255-264)
        if self.damped_multipliers:
            y0, z0 = self.y, self.z
            sy_y = mk.sub(self.ip_state.y, self.y)
            sz_z = mk.sub(self.ip_state.z, self.z)
        self.y = self.ip_state.y
        self.z = self.ip_state.z
        self.re = self._update_r(self.y, self.re)
        self.r = self._update_r(self.z, self.r)

        x0 = self.x
        qp0 = qp
        phi0, dphi0 = self._phi_pair(qp)
        phik = phi0

        alpha = self.min_alpha if dphi0 > 0.0 else 1.0

        # watchdog bookkeeping (C:280-346)
        if self.iter == 0:
            self._phil = phi0
        if self._watchdog_iter < 0:
            self._phil_test = self._phil
            self._phil = phi0
        if self.watchdog_credit > 0 and self.iter >= self.watchdog_start:
            if phi0 <= self._phil_test:
                self._relaxed = True
                self.wd_relaxed_steps += 1
                self._watchdog_iter = self.iter
                self._wd_backup = (x0, self.s, self.y, self.z)
                self._phil = phi0
                if dphi0 < 0.0:
                    self._phil_test += 0.1 * self.min_alpha * dphi0
            else:
                self._relaxed = False
            if (self._watchdog_iter >= 0 and
                    self.iter >= self._watchdog_iter + self.watchdog_credit):
                # back out to the stored iterate (C:313-345)
                self.wd_backouts += 1
                xl, sl_, yl, zl = self._wd_backup
                self.x = xl
                self.y, self.z = yl, zl
                f, qpn = self.prg.make_qp(self.x, Q=self.qp.Q)
                self.f, self.qp = f, qpn
                self.hela_restart()
                if self.damped_multipliers:
                    y0, z0 = self.y, self.z
                    sy_y = mk.fill(self.y, 0.0)
                    sz_z = mk.fill(self.z, 0.0)
                self.re = self._update_r(self.y, self.re)
                self.r = self._update_r(self.z, self.r)
                self.s = sl_
                qp = self.qp
                x0 = self.x
                phi0, dphi0 = self._phi_pair(qp)
                phik = phi0
                self._phil = phi0
                self._relaxed = False
                self._watchdog_iter = -1

        # line search (C:350-377)
        while True:
            xk = x0 + alpha * self.s
            if self.damped_multipliers and alpha < 1.0:
                self.y = mk.axpy(alpha, sy_y, y0)
                self.z = mk.axpy(alpha, sz_z, z0)
            f, qpv = self.prg.update_fbd_qp(qp0, x0, xk)
            self.x, self.f, self.qp = xk, f, qpv
            if alpha <= self.min_alpha:
                break
            if self._relaxed and self.watchdog_credit > 0:
                break  # accept the full step under watchdog relaxation
            fv, phik = host(torch.stack([f, _phi(f, qpv, self.re, self.r)]))
            if not math.isfinite(fv):
                alpha *= 0.1
                continue
            if phik <= phi0 + 0.1 * alpha * dphi0 or abs(dphi0) <= eps:
                break
            n_alpha = 0.5 * dphi0 * alpha * alpha / \
                (dphi0 * alpha - (phik - phi0))
            if abs(alpha - n_alpha) < self.min_alpha:
                break
            alpha = max(alpha * 0.1, n_alpha, self.min_alpha)

        self.alpha = alpha
        self.d = alpha * self.s
        self.dphi = dphi0
        self.phi = phi0
