"""DTOpt / DTEst: discrete-time optimization and estimation formulations.

Port of ``hqp_tpu/omu/dt_opt.py`` (reference: omu/Prg_DTOpt.{h,C},
omu/Prg_DTEst.{h,C}): the DynamicOpt / DynamicEst formulations built
directly on the DOCP layer for purely discrete-time models -- no
integrator; the model's discrete update (mdlUpdate role) is the stage map
and its outputs (mdlOutputs role) enter the weighted criterion
(Prg_DTOpt.h:1-25).  Consumes any :class:`hqp_tpu_torch.omu.model.Model`
with ``dt_update`` -- models in torch ops and hosted S-functions
(:class:`hqp_tpu_torch.omu.hosted.HostedModel`) alike.  Also registers
the reference's aliases SFunctionOpt and SFunctionEst.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.program import Docp
# these imports also register the aliases' targets, DynamicEst and
# DynamicOpt, so that this module may be imported first
from hqp_tpu_torch.omu.dynamic_est import EstimationLayout
from hqp_tpu_torch.omu.dynamic_opt import knob
from hqp_tpu_torch.omu.model import Model
from hqp_tpu_torch.utils.registry import modules


@modules.register("prg_name", "DTOpt")
class DTOpt(Docp):
    """Weighted optimal control of a discrete-time model.

    Objective terms mirror Prg_DTOpt's weighted formulation: quadratic
    and linear output terms along the path and at the final stage,
    quadratic control terms, soft output bounds as quadratic penalties,
    hard output bounds as general constraint rows.
    """

    name = "DTOpt"

    def __init__(self, model: Model, K: int = 50, dt: float = 1.0,
                 x0=None, x0_fixed=True,
                 u_min=None, u_max=None, u_init=None,
                 y_ref=None, y_weight2=None, y_weight1=None,
                 yf_ref=None, yf_weight2=None, yf_weight1=None,
                 u_ref=None, u_weight2=None,
                 y_min=None, y_max=None,
                 y_soft_min=None, y_soft_max=None, s_quad=1e4,
                 device="cuda"):
        super().__init__(device)
        self.model = model
        self.K = K
        self.dt = float(dt)
        self.nx = model.nx
        self.nu = model.nu
        ny = model.ny
        t = self._t

        self.x0 = knob(x0, model.nx, 0.0)
        self.x0_fixed = x0_fixed
        self._u_min = knob(u_min, model.nu, -np.inf)
        self._u_max = knob(u_max, model.nu, np.inf)
        self._u_init = knob(u_init, model.nu, 0.0)
        self.y_ref = t(knob(y_ref, ny, 0.0))
        self.y_w2 = t(knob(y_weight2, ny, 0.0))
        self.y_w1 = t(knob(y_weight1, ny, 0.0))
        self.yf_ref = t(knob(yf_ref, ny, 0.0))
        self.yf_w2 = t(knob(yf_weight2, ny, 0.0))
        self.yf_w1 = t(knob(yf_weight1, ny, 0.0))
        self.u_ref = t(knob(u_ref, model.nu, 0.0))
        self.u_w2 = t(knob(u_weight2, model.nu, 0.0))
        self.y_min = knob(y_min, ny, -np.inf)
        self.y_max = knob(y_max, ny, np.inf)
        self.y_soft_min = t(knob(y_soft_min, ny, -np.inf))
        self.y_soft_max = t(knob(y_soft_max, ny, np.inf))
        self.s_quad = s_quad
        self.ynom = t(knob(model.y_nominal, ny, 1.0))
        self._hard = bool((np.isfinite(self.y_min)
                           | np.isfinite(self.y_max)).any())
        self.mc = ny if self._hard else 0
        self._p = model.default_p(self.device)

    def setup_vars(self):
        K, K1, nx = self.K, self.K + 1, self.nx
        inf = np.inf
        x_min = np.full((K1, nx), -inf)
        x_max = np.full((K1, nx), inf)
        x_init = np.tile(self.x0, (K1, 1))
        if self.x0_fixed:
            x_min[0] = x_max[0] = self.x0
        out = dict(
            x_min=x_min, x_max=x_max, x_init=x_init,
            u_min=np.tile(self._u_min, (K, 1)),
            u_max=np.tile(self._u_max, (K, 1)),
            u_init=np.tile(self._u_init, (K, 1)),
        )
        if self._hard:
            out["c_min"] = np.tile(self.y_min, (K1, 1))
            out["c_max"] = np.tile(self.y_max, (K1, 1))
        return out

    # -- stage maps ------------------------------------------------------------
    def f(self, k, x, u):
        return self.model.dt_update(k * self.dt, x, u, self._p)

    def _y(self, k, x, u):
        return self.model.outputs(k * self.dt, x, u, self._p)

    def f0(self, k, x, u):
        y = self._y(k, x, u)
        final = k >= self.K
        ys = (y - torch.where(final, self.yf_ref, self.y_ref)) / self.ynom
        w2 = torch.where(final, self.yf_w2, self.y_w2)
        w1 = torch.where(final, self.yf_w1, self.y_w1)
        J = torch.sum(w2 * ys * ys) + torch.sum(w1 * y)
        zero = torch.zeros_like(y)
        lo = torch.where(torch.isfinite(self.y_soft_min),
                         torch.maximum(zero, self.y_soft_min - y), 0.0)
        hi = torch.where(torch.isfinite(self.y_soft_max),
                         torch.maximum(zero, y - self.y_soft_max), 0.0)
        J = J + self.s_quad * (torch.sum(lo * lo) + torch.sum(hi * hi))
        us = u - self.u_ref
        return J + torch.where(final, 0.0, torch.sum(self.u_w2 * us * us))

    def c(self, k, x, u):
        if not self._hard:
            return x.new_zeros((0,))
        return self._y(k, x, u)


@modules.register("prg_name", "DTEst")
class DTEst(EstimationLayout, Docp):
    """Discrete-time least-squares estimation (Prg_DTEst role): fit the
    model's outputs to measurements over one or more experiments,
    estimating parameters (promoted to constant states) and optionally
    initial states; confidence intervals as in DynamicEst."""

    name = "DTEst"

    def __init__(self, model: Model, ys_meas, us=None, K=None,
                 dt: float = 1.0,
                 p_init=None, p_min=None, p_max=None,
                 x0_init=None, estimate_x0=False, device="cuda"):
        super().__init__(device)
        self.model = model
        self._setup_estimation(model, ys_meas, us, K, p_init, p_min, p_max,
                               x0_init, estimate_x0)
        self.dt = float(dt)

    def f(self, k, x, u):
        p, xs = self._split(x)
        t = k * self.dt
        xn = torch.func.vmap(
            lambda xe, ue: self.model.dt_update(t, xe, ue, p))(
                xs, self._inputs(k))
        return torch.cat([p, xn.reshape(-1)])

    def _residuals(self, k, x):
        p, xs = self._split(x)
        t = k * self.dt
        ys = torch.func.vmap(
            lambda xe, ue: self.model.outputs(t, xe, ue, p))(
                xs, self._inputs(k))
        return (ys - self._measured(k)) / self.ynom

    def f0(self, k, x, u):
        r = self._residuals(k, x)
        return torch.sum(r * r)

    def confidence(self, v):
        """COV and ~95% confidence half-widths (Prg_DTEst / DynamicEst
        confidence computation, omu/Prg_DynamicEst.h:225-378)."""
        ks = torch.arange(self.K + 1, device=self.device)

        def all_res(theta):
            xk, xs = theta, []
            for k in range(self.K):
                xs.append(xk)
                xk = self.f(ks[k], xk, theta.new_zeros((0,)))
            xs = torch.stack([*xs, xk])
            return torch.func.vmap(self._residuals)(ks, xs).reshape(-1)

        return self._confidence(v, all_res)


# the reference's names (Prg_DynamicOpt.h:947, Prg_DynamicEst.h:508
# register SFunctionOpt/SFunctionEst), resolved when called
def _alias(name, base_slot_name):
    def factory(*args, **kwargs):
        return modules.create("prg_name", base_slot_name, *args, **kwargs)
    modules.register("prg_name", name)(factory)


_alias("SFunctionOpt", "DynamicOpt")
_alias("SFunctionEst", "DynamicEst")
