"""DynamicEst: parameter and initial-state estimation with confidence
intervals.

Port of ``hqp_tpu/omu/dynamic_est.py`` (reference: omu/Prg_DynamicEst.
{h,C}): least-squares fit of model outputs to measurements over one or
more experiments,

    min  sum_ex sum_k sum_i ((y_i(t_k) - y_meas)/y_nominal)^2

with selected model parameters p and/or initial states x0 estimated.
Estimated parameters are promoted to constant states (p' = 0) so the
whole problem stays a stage-structured DOCP; multiple experiments are a
``torch.func.vmap`` inside the stage functions (the stage axis carries
all experiments at once).

After solving, the measurement sensitivity matrix M = dy/d(p, x0), the
covariance COV = s^2 (M'M)^-1 and the confidence intervals
(Prg_DynamicEst.h:225-378: mdl_p_confidence / mdl_x0_confidence) come
from ``torch.func.jacfwd`` of the whole rollout, a Python loop over the
K stages where the reference scans.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.omu.integrators import RK4
from hqp_tpu_torch.omu.model import Model
from hqp_tpu_torch.omu.program import OmuProgram, at
from hqp_tpu_torch.utils.registry import modules


class EstimationLayout:
    """What DynamicEst and DTEst share: the measurement tables, the state
    layout [p (np_est) | x (nx * n_ex)] with its bounds and starts, the
    known inputs at a stage, and the confidence intervals."""

    def _setup_estimation(self, model, ys_meas, us, K, p_init, p_min,
                          p_max, x0_init, estimate_x0):
        ys = np.asarray(ys_meas, np.float64)
        if ys.ndim == 2:
            ys = ys[None]
        self.n_ex = ys.shape[0]
        self.K = K if K is not None else ys.shape[1] - 1
        assert ys.shape[1] == self.K + 1
        self.ys_meas = self._t(ys)                      # [n_ex, K+1, ny]
        if us is None:
            us = np.zeros((self.n_ex, self.K, model.nu))
        self.us_known = self._t(np.asarray(us, np.float64))

        self.np_est = model.npar
        self.estimate_x0 = estimate_x0
        self.nx = self.np_est + model.nx * self.n_ex
        self.nu = 0
        self.mc = 0

        self.p_init = np.broadcast_to(
            np.asarray(p_init if p_init is not None else model.p0,
                       np.float64), (self.np_est,)).copy()
        self.p_min = np.broadcast_to(
            np.asarray(p_min if p_min is not None else -np.inf),
            (self.np_est,)).copy()
        self.p_max = np.broadcast_to(
            np.asarray(p_max if p_max is not None else np.inf),
            (self.np_est,)).copy()
        self.x0_init = np.broadcast_to(
            np.asarray(x0_init if x0_init is not None else 0.0,
                       np.float64), (self.n_ex, model.nx)).copy()
        self.ynom = self._t(np.broadcast_to(
            np.asarray(model.y_nominal if model.y_nominal is not None
                       else 1.0, np.float64), (model.ny,)).copy())

    def setup_vars(self):
        K1, nx = self.K + 1, self.nx
        inf = np.inf
        x_min = np.full((K1, nx), -inf)
        x_max = np.full((K1, nx), inf)
        x_min[:, : self.np_est] = self.p_min
        x_max[:, : self.np_est] = self.p_max
        x_init = np.zeros((K1, nx))
        x_init[:, : self.np_est] = self.p_init
        x_init[:, self.np_est:] = self.x0_init.reshape(-1)
        if not self.estimate_x0:
            x_min[0, self.np_est:] = x_max[0, self.np_est:] = \
                self.x0_init.reshape(-1)
        return dict(x_min=x_min, x_max=x_max, x_init=x_init)

    def _split(self, xall):
        p = xall[: self.np_est]
        xs = xall[self.np_est:].reshape(self.n_ex, self.model.nx)
        return p, xs

    def _inputs(self, kk):
        """The known inputs [n_ex, nu] of stage (sample period) kk."""
        return at(self.us_known.transpose(0, 1),
                  torch.clamp(kk, max=self.K - 1))

    def _measured(self, kk):
        """The measurements [n_ex, ny] at stage (sample period) kk."""
        return at(self.ys_meas.transpose(0, 1), torch.clamp(kk, max=self.K))

    def _confidence(self, v, rollout):
        """COV and ~95% confidence half-widths of the estimates at the
        converged iterate v [K1, nv]: ``rollout(theta)`` gives the
        residuals of the whole horizon from theta = (p, x0)."""
        theta0 = torch.cat([v[0, : self.np_est], v[0, self.np_est: self.nx]])
        r = rollout(theta0)
        M = torch.func.jacfwd(rollout)(theta0)
        dof = max(r.shape[0] - theta0.shape[0], 1)
        s2 = torch.sum(r * r) / dof
        eye = torch.eye(M.shape[1], dtype=M.dtype, device=M.device)
        cov = s2 * torch.linalg.inv(M.T @ M + 1e-300 * eye)
        half = 1.96 * torch.sqrt(torch.diagonal(cov))
        return cov, half


@modules.register("prg_name", "DynamicEst")
class DynamicEst(EstimationLayout, OmuProgram):
    """Least-squares estimation over a :class:`Model`.

    State layout per stage: [p (np_est) | x (nx * n_ex)]; there are no
    u variables: the known experiment inputs enter through the time grid.
    """

    name = "DynamicEst"

    def __init__(self, model: Model, ys_meas, us=None, K=None,
                 t0=0.0, tf=1.0, integrator=None,
                 p_init=None, p_min=None, p_max=None,
                 x0_init=None, estimate_x0=False, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=2), device)
        self.model = model
        self._setup_estimation(model, ys_meas, us, K, p_init, p_min, p_max,
                               x0_init, estimate_x0)
        self.t0, self.tf = float(t0), float(tf)

    # -- stage maps ----------------------------------------------------------

    def continuous(self, kk, t, x, u, dx):
        p, xs = self._split(x)
        dxs = torch.func.vmap(lambda xe, ue: self.model.ode(t, xe, ue, p))(
            xs, self._inputs(kk))
        F = torch.cat([x.new_zeros(self.np_est), dxs.reshape(-1)])
        return F - dx

    def _residuals(self, kk, t, x):
        p, xs = self._split(x)
        ys = torch.func.vmap(
            lambda xe, ue: self.model.outputs(t, xe, ue, p))(
                xs, self._inputs(kk))                         # [n_ex, ny]
        return (ys - self._measured(kk)) / self.ynom

    def update(self, kk, x, u, xf):
        t = at(self.ts, torch.clamp(kk, max=self.K))
        r = self._residuals(kk, t, x)
        return xf, torch.sum(r * r), x.new_zeros((0,))

    # -- post-processing: covariance and confidence intervals ----------------

    def confidence(self, v):
        """COV and ~95% confidence half-widths for the estimates
        (Prg_DynamicEst.h:225-378).  v: converged iterate [K1, nv]."""
        ks = torch.arange(self.K + 1, device=self.device)

        def all_res(theta):
            xk, xs = theta, []
            for k in range(self.K):
                xs.append(xk)
                xk = self.integrator.solve(self.continuous, ks[k],
                                           self.ts[k], self.ts[k + 1], xk,
                                           theta.new_zeros((0,)))
            xs = torch.stack([*xs, xk])
            rs = torch.func.vmap(lambda k, xk: self._residuals(
                k, at(self.ts, torch.clamp(k, max=self.K)), xk))(ks, xs)
            return rs.reshape(-1)

        return self._confidence(v, all_res)
