"""DynamicOpt: the flagship weighted optimal-control formulation.

Port of ``hqp_tpu/omu/dynamic_opt.py`` (reference: omu/Prg_DynamicOpt.
{h,C}; formulation documented at Prg_DynamicOpt.h:36-200): optimal
control of a :class:`hqp_tpu_torch.omu.model.Model` -- written in torch
ops, or hosted (:class:`hqp_tpu_torch.omu.hosted.HostedModel`) -- with
the fully weighted objective

    J = sum_initial + sum_path + sum_final  of
        y_lin*y + y_quad*((y - y_ref)/y_nominal)^2
      + u_lin*u + u_quad*((u - u_ref)/u_nominal)^2 + du_quad*(du/dt)^2
      + s_lin*s + s_quad*s^2          (soft-constraint slack variables)
      + t_lin*T                       (free final time, mdl_t_scale)

realized with the reference's own mechanisms, re-expressed stage-locally:

* soft path constraints  y_soft_min <= y <= y_soft_max  use genuine SLACK
  VARIABLES (extra per-stage controls s >= 0 with rows y + s >= y_soft_min
  / y - s <= y_soft_max) carrying linear (L1) + quadratic weights --
  Prg_DynamicOpt.h:85-89, 201-223, `_ns` h:333.  With only quadratic
  weight the slack-free penalty form is used instead (equivalent).
* piecewise-LINEAR controls (``u_order=1``, the reference default
  mdl_u_order h:317): the control becomes a state with du as the real
  optimization variable (u' = du over each period) -- which also gives the
  du_quad rate term for free.  ``u_order=0`` keeps piecewise-constant
  controls; a nonzero du weight then augments the state with the previous
  u (discrete update) and penalizes (u_k - u_{k-1}).
* free final time (`mdl_t_scale_active` h:321-324): a constant extra
  state T with dT' = 0 scales the dynamics dx = T f(x, u); horizon time
  runs over [0, 1] and the physical final time T is optimized (weight
  ``t_weight1`` => minimum-time problems).
* ``decimation`` (h:233-240): the model is sampled `decimation` times per
  control stage (maps onto Omu sample periods per stage, `sps`).
* final-stage output bounds yf_min/yf_max (the reference's separate
  initial/path/final constraint sets).
* periodic states and controls (``x_periodic``/``u_periodic``) through
  constant memory states.

The sample-period index ``kk`` is a tensor that the stage ``vmap``
batches: tables are read at it by :func:`hqp_tpu_torch.omu.program.at`,
and every branch on it is a ``torch.where``.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.omu.integrators import RK4
from hqp_tpu_torch.omu.model import Model
from hqp_tpu_torch.omu.program import OmuProgram, at
from hqp_tpu_torch.utils.registry import modules


def knob(v, size, default):
    """``v`` broadcast to [size] float64 (``default`` where v is None)."""
    if v is None:
        return np.full(size, default, np.float64)
    return np.broadcast_to(np.asarray(v, np.float64), (size,)).copy()


@modules.register("prg_name", "DynamicOpt")
class DynamicOpt(OmuProgram):
    """Weighted optimal control of a :class:`Model` over [t0, tf]."""

    name = "DynamicOpt"

    def __init__(self, model: Model, K: int = 50, t0=0.0, tf=1.0,
                 integrator=None,
                 x0=None, x0_fixed=True,
                 u_min=None, u_max=None, u_init=None,
                 du_min=None, du_max=None,
                 y_ref=None, y_weight2=None, y_weight1=None,
                 yf_ref=None, yf_weight2=None, yf_weight1=None,
                 u_ref=None, u_weight2=None, u_weight1=None,
                 du_weight2=None,
                 y_min=None, y_max=None, yf_min=None, yf_max=None,
                 y_soft_min=None, y_soft_max=None,
                 s_quad=1e4, s_lin=0.0,
                 u_order: int = 0,
                 t_scale: bool = False, t_weight1=0.0,
                 t_scale_min=0.1, t_scale_max=10.0,
                 decimation: int = 1,
                 x_periodic=None, u_periodic=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=2), device)
        self.model = model
        self.K = K
        self.t0, self.tf = float(t0), float(tf)
        self.sps = max(1, int(decimation))

        nxm, num, ny = model.nx, model.nu, model.ny
        self.nxm, self.num, self.ny = nxm, num, ny
        t = self._t

        self.x0 = knob(x0, nxm, 0.0)
        self.x0_fixed = x0_fixed
        self._u_min = knob(u_min, num, -np.inf)
        self._u_max = knob(u_max, num, np.inf)
        self._du_min = knob(du_min, num, -np.inf)
        self._du_max = knob(du_max, num, np.inf)
        self._u_init = knob(u_init, num, 0.0)
        self.y_ref = t(knob(y_ref, ny, 0.0))
        self.y_w2 = t(knob(y_weight2, ny, 0.0))
        self.y_w1 = t(knob(y_weight1, ny, 0.0))
        self.yf_ref = t(knob(yf_ref, ny, 0.0))
        self.yf_w2 = t(knob(yf_weight2, ny, 0.0))
        self.yf_w1 = t(knob(yf_weight1, ny, 0.0))
        self.u_ref = t(knob(u_ref, num, 0.0))
        self.u_w2 = t(knob(u_weight2, num, 0.0))
        self.u_w1 = t(knob(u_weight1, num, 0.0))
        du_w2 = knob(du_weight2, num, 0.0)
        self.du_w2 = t(du_w2)
        self.y_min = knob(y_min, ny, -np.inf)
        self.y_max = knob(y_max, ny, np.inf)
        self.yf_min = knob(yf_min, ny, np.nan)   # nan = inherit path bound
        self.yf_max = knob(yf_max, ny, np.nan)
        soft_min = knob(y_soft_min, ny, -np.inf)
        soft_max = knob(y_soft_max, ny, np.inf)
        self.y_soft_min = t(soft_min)
        self.y_soft_max = t(soft_max)
        self.s_quad = t(knob(s_quad, ny, 0.0))
        s_lin = knob(s_lin, ny, 0.0)
        self.s_lin = t(s_lin)
        self.ynom = t(knob(model.y_nominal, ny, 1.0))

        # -- layout -----------------------------------------------------------
        if u_order not in (0, 1):
            raise ValueError("u_order must be 0 or 1 (mdl_u_order)")
        self.u_order = u_order
        self._du_pen = bool(np.any(du_w2 > 0.0))
        #: controls live as states (piecewise linear, or u_prev tracking)
        self._u_state = (u_order == 1) or self._du_pen
        self.t_free = bool(t_scale)
        self.t_w1 = float(t_weight1)
        self.t_min, self.t_max = float(t_scale_min), float(t_scale_max)

        self._iu0 = nxm if self._u_state else None
        self._iT = nxm + (num if self._u_state else 0)
        self.nx = self._iT + (1 if self.t_free else 0)

        # periodic controls/states (mdl_u_periodic / mdl_x_periodic,
        # Prg_DynamicOpt.h:377,382): the reference's global equality row
        # x_0[i] - x_K[i] = 0 would couple stage 0 with stage K, so each
        # periodic variable gets a constant MEMORY STATE p (dp/dt = 0)
        # pinned to it by a stage-0 equality row p = x and a terminal row
        # p = x -- together x_0 = x_K, with only stage-local rows
        xper = np.asarray(knob(x_periodic, nxm, 0.0), bool) \
            if x_periodic is not None else np.zeros(nxm, bool)
        uper = np.asarray(knob(u_periodic, num, 0.0), bool) \
            if u_periodic is not None else np.zeros(num, bool)
        if uper.any() and not self._u_state:
            raise ValueError(
                "u_periodic requires the control to be a state "
                "(u_order=1 or a du weight), as in the reference "
                "(Prg_DynamicOpt.C:541 marks the control STATE periodic)")
        self._x_per = xper
        self._per_src = np.concatenate([
            np.where(xper)[0],
            (self._iu0 or 0) + np.where(uper)[0]]).astype(int)
        self.npx = len(self._per_src)
        self._iper = self.nx
        self.nx += self.npx

        # soft constraints: slack variables iff a linear weight is present
        soft_lo = np.isfinite(soft_min)
        soft_hi = np.isfinite(soft_max)
        self._soft_any = bool(soft_lo.any() or soft_hi.any())
        self._slack = self._soft_any and bool(np.any(s_lin > 0.0))
        self._soft_lo_idx = np.where(soft_lo)[0]
        self._soft_hi_idx = np.where(soft_hi)[0]
        ns = (len(self._soft_lo_idx) + len(self._soft_hi_idx)
              if self._slack else 0)
        self.ns = ns
        self.nu = num + ns

        # index tensors of the static layout
        ix = lambda a: torch.as_tensor(a, dtype=torch.long,  # noqa: E731
                                       device=self.device)
        self._lo_t, self._hi_t = ix(self._soft_lo_idx), ix(self._soft_hi_idx)
        self._sidx_t = ix(np.concatenate([self._soft_lo_idx,
                                          self._soft_hi_idx]))
        self._per_t = ix(self._per_src)

        # hard output bounds (path or final) become general constraint rows
        hard_path = np.isfinite(self.y_min) | np.isfinite(self.y_max)
        hard_fin = np.isfinite(self.yf_min) | np.isfinite(self.yf_max)
        self._hard = bool(hard_path.any() or hard_fin.any())
        self.mc = (ny if self._hard else 0) + ns + self.npx

        self._p = model.default_p(self.device)

    # -- bounds --------------------------------------------------------------

    def setup_vars(self):
        K, K1, nx, nu = self.K, self.K + 1, self.nx, self.nu
        nxm, num, ny, ns = self.nxm, self.num, self.ny, self.ns
        inf = np.inf
        x_min = np.full((K1, nx), -inf)
        x_max = np.full((K1, nx), inf)
        x_init = np.zeros((K1, nx))
        x_init[:, :nxm] = self.x0
        if self.x0_fixed:
            # periodic states are determined by the periodicity rows, not
            # by a pinned initial value (reference: the Periodical mark
            # REPLACES the x0 bound, Prg_DynamicOpt.C:575-577)
            fix = ~self._x_per
            x_min[0, :nxm][fix] = x_max[0, :nxm][fix] = self.x0[fix]
        if self.u_order == 1:
            # the control ramp knots are states: bound + initialize them
            x_min[:, self._iu0:self._iu0 + num] = self._u_min
            x_max[:, self._iu0:self._iu0 + num] = self._u_max
            x_init[:, self._iu0:self._iu0 + num] = self._u_init
        elif self._u_state:
            x_init[:, self._iu0:self._iu0 + num] = self._u_init
        if self.t_free:
            x_min[:, self._iT] = self.t_min
            x_max[:, self._iT] = self.t_max
            x_init[:, self._iT] = 1.0
        if self.npx:
            # memory states start at their source variable's guess
            x_init[:, self._iper:] = x_init[:, self._per_src]

        u_min = np.full((K, nu), -inf)
        u_max = np.full((K, nu), inf)
        u_init = np.zeros((K, nu))
        if self.u_order == 1:
            u_min[:, :num] = self._du_min
            u_max[:, :num] = self._du_max
        else:
            u_min[:, :num] = self._u_min
            u_max[:, :num] = self._u_max
            u_init[:, :num] = self._u_init
        if ns:
            u_min[:, num:] = 0.0          # slacks s >= 0

        out = dict(x_min=x_min, x_max=x_max, x_init=x_init,
                   u_min=u_min, u_max=u_max, u_init=u_init)

        if self.mc:
            c_min = np.full((K1, self.mc), -inf)
            c_max = np.full((K1, self.mc), inf)
            if self._hard:
                c_min[:, :ny] = self.y_min
                c_max[:, :ny] = self.y_max
                # final-stage set: yf bound where given, else path bound
                c_min[K, :ny] = np.where(np.isnan(self.yf_min),
                                         self.y_min, self.yf_min)
                c_max[K, :ny] = np.where(np.isnan(self.yf_max),
                                         self.y_max, self.yf_max)
            if ns:
                off = ny if self._hard else 0
                # slack rows (path stages only; stage K has no controls,
                # its soft terms fall back to the quadratic penalty)
                c_min[:K, off:off + ns] = 0.0
            if self.npx:
                # periodicity rows: equality p = x, active (nonzero) only
                # at period 0 and the terminal point -- identically zero
                # elsewhere, so the 0-bounds hold trivially there
                offp = (ny if self._hard else 0) + ns
                c_min[:, offp:] = 0.0
                c_max[:, offp:] = 0.0
            out["c_min"] = c_min
            out["c_max"] = c_max
        return out

    # -- pieces --------------------------------------------------------------

    def _split(self, x, u):
        """(x_model, u_real_for_model, T, du, s) at a path stage."""
        xm = x[: self.nxm]
        if self.u_order == 1:
            ur = x[self._iu0: self._iu0 + self.num]
            du = u[: self.num]
        else:
            ur = u[: self.num]
            du = None
        T = x[self._iT] if self.t_free else 1.0
        s = u[self.num:] if self.ns else None
        return xm, ur, T, du, s

    # -- dynamics ------------------------------------------------------------

    def continuous(self, kk, t, x, u, dx):
        xm, ur, T, du, _ = self._split(x, u)
        rows = [T * self.model.ode(t, xm, ur, self._p) - dx[: self.nxm]]
        if self._u_state:
            rate = (u[: self.num] if self.u_order == 1
                    else x.new_zeros(self.num))
            rows.append(rate - dx[self._iu0: self._iu0 + self.num])
        if self.t_free:
            rows.append(-dx[self._iT: self._iT + 1])
        if self.npx:
            # constant memory states of the periodic variables
            rows.append(-dx[self._iper: self._iper + self.npx])
        return torch.cat(rows)

    # -- objective + constraints ---------------------------------------------

    def _soft_penalty(self, y):
        """Quadratic-only soft penalty (slack-free form)."""
        zero = torch.zeros_like(y)
        lo = torch.where(torch.isfinite(self.y_soft_min),
                         torch.maximum(zero, self.y_soft_min - y), 0.0)
        hi = torch.where(torch.isfinite(self.y_soft_max),
                         torch.maximum(zero, y - self.y_soft_max), 0.0)
        return torch.sum(self.s_quad * (lo * lo + hi * hi)) \
            + torch.sum(self.s_lin * (lo + hi))

    def _stage_cost(self, kk, t, x, u, xf, final):
        xm, ur, T, du, s = self._split(x, u)
        y = self.model.outputs(t, xm, ur, self._p)
        ys = (y - torch.where(final, self.yf_ref, self.y_ref)) / self.ynom
        w2 = torch.where(final, self.yf_w2, self.y_w2)
        w1 = torch.where(final, self.yf_w1, self.y_w1)
        J = torch.sum(w2 * ys * ys) + torch.sum(w1 * y)

        if self._slack:
            # path: linear + quadratic slack weights; final: penalty form
            Js = (torch.sum(self.s_lin[self._sidx_t] * s)
                  + torch.sum(self.s_quad[self._sidx_t] * s * s))
            J = J + torch.where(final, self._soft_penalty(y), Js)
        elif self._soft_any:
            J = J + self._soft_penalty(y)

        us = ur - self.u_ref
        J = J + torch.where(final, 0.0,
                            torch.sum(self.u_w2 * us * us)
                            + torch.sum(self.u_w1 * ur))
        if self._du_pen:
            if self.u_order == 1:
                dr = du
            else:
                # piecewise-constant controls change once per STAGE, so
                # the discrete rate uses the stage period sps*dt, not the
                # sub-sample period
                dt = (self.ts[1] - self.ts[0]) * self.sps
                dr = (ur - x[self._iu0: self._iu0 + self.num]) / dt
                # no previous control before stage 0
                dr = torch.where(kk == 0, torch.zeros_like(dr), dr)
            J = J + torch.where(final, 0.0, torch.sum(self.du_w2 * dr * dr))
        if self.t_free:
            # constant state: charge once, at the final stage
            J = J + torch.where(final, self.t_w1 * T, 0.0)
        return J

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        t = at(self.ts, kk)
        final = kk >= KK
        f0 = self._stage_cost(kk, t, x, u, xf, final)

        # discrete part of the state update
        f = xf
        if self._u_state and self.u_order == 0:
            # u_prev tracking state: copy the applied control forward
            i0, i1 = self._iu0, self._iu0 + self.num
            f = torch.cat([f[:i0], u[: self.num], f[i1:]])

        # constraint rows
        cs = []
        xm, ur, T, du, s = self._split(x, u)
        y = self.model.outputs(t, xm, ur, self._p)
        if self._hard:
            cs.append(y)
        if self.ns:
            nlo = len(self._soft_lo_idx)
            cs.append(torch.cat([
                y[self._lo_t] + s[:nlo] - self.y_soft_min[self._lo_t],
                self.y_soft_max[self._hi_t] - y[self._hi_t] + s[nlo:]]))
        if self.npx:
            # periodicity rows p - x: active at period 0 and the terminal
            # update only (x_0 = p = x_K through the constant p chain)
            active = (kk == 0) | final
            per = x[self._iper: self._iper + self.npx] - x[self._per_t]
            cs.append(torch.where(active, per, torch.zeros_like(per)))
        c = torch.cat(cs) if cs else x.new_zeros((0,))
        return f, f0, c
