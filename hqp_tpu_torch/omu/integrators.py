"""ODE integrators with differentiable sensitivities (fixed-step part).

Port of ``hqp_tpu/omu/integrators.py`` (reference: omu/Omu_Integrator.{h,C}
and subclasses): ``Euler``, ``RK4`` and the implicit midpoint rule ``IMP``.
Each advances one sample period; all stages run batched under
``torch.func.vmap``, and sensitivities come from ``torch.func.jacfwd``
*through* the integrator instead of hand-propagated sensitivity ODEs.  The
reference's ``lax.fori_loop`` over the static ``steps`` is a Python loop.
``IMP`` solves its Newton system under :class:`_NewtonRoot`, whose forward
derivative comes from the implicit function theorem, never from
differentiating the Newton iterations (the role of ``lax.custom_root``).

The model interface is the implicit residual of the reference
(omu/Omu_Program.h continuous): F(kk, t, x, u, dx) = 0 with dx entering
linearly; explicit integrators recover xdot = F(kk, t, x, u, 0).

Not ported yet: the adaptive integrators (``Dopri5``, ``RKsuite``,
``RKF78``, ``IMPAdaptive``, ``BDFAdaptive``), ``GRK4``, ``SDIRK``,
``BDF``/``BDFVarOrder`` and ``OdeTs`` (ROADMAP Q1).
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import smalllin as sl
from hqp_tpu_torch.utils.registry import modules


class Integrator:
    """Base integrator (Omu_Integrator analog): ``steps`` fixed steps a
    sample period (the reference's ``stepsize``/``rtol``/``atol`` serve
    only its adaptive integrators, which are not ported yet).

    solve(F, kk, t0, t1, x, u) -> x(t1), where F is the implicit residual.
    """

    def __init__(self, steps: int = 1):
        self.steps = steps

    def _xdot(self, F, kk, t, x, u):
        return F(kk, t, x, u, torch.zeros_like(x))

    def solve(self, F, kk, t0, t1, x, u):
        raise NotImplementedError


@modules.register("prg_integrator", "Euler")
class Euler(Integrator):
    """Fixed-step explicit Euler (omu/Omu_IntEuler.C)."""

    def solve(self, F, kk, t0, t1, x, u):
        h = (t1 - t0) / self.steps
        xs = x
        for i in range(self.steps):
            xs = xs + h * self._xdot(F, kk, t0 + i * h, xs, u)
        return xs


@modules.register("prg_integrator", "RK4")
class RK4(Integrator):
    """Fixed-step classical Runge-Kutta (omu/Omu_IntRK4.C)."""

    def solve(self, F, kk, t0, t1, x, u):
        h = (t1 - t0) / self.steps
        xs = x
        for i in range(self.steps):
            t = t0 + i * h
            k1 = self._xdot(F, kk, t, xs, u)
            k2 = self._xdot(F, kk, t + 0.5 * h, xs + 0.5 * h * k1, u)
            k3 = self._xdot(F, kk, t + 0.5 * h, xs + 0.5 * h * k2, u)
            k4 = self._xdot(F, kk, t + h, xs + h * k3, u)
            xs = xs + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return xs


class _NewtonRoot(torch.autograd.Function):
    """z* with res(z*, *params) = 0 by ``iters`` undamped Newton steps
    from z0, differentiated by the implicit function theorem:
    dz = -J^-1 (d res / d params) dparams with J = d res / dz at z*, both
    solved by the pivot-free LU as the reference's ``tangent_solve`` does.
    ``params`` are tensors (the residual's only inputs besides z); integer
    ones carry no tangent.  Forward mode only: it runs under the stage
    ``vmap`` and ``jacfwd`` of ``Docp.eval_derivs``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(res, iters, z0, *params):
        z = z0
        for _ in range(iters):
            J = torch.func.jacfwd(res)(z, *params)
            z = z - sl.solve_nopiv(J, res(z, *params))
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.res = inputs[0]
        ctx.save_for_forward(output, *inputs[3:])

    @staticmethod
    def jvp(ctx, _res_t, _iters_t, _z0_t, *param_tangents):
        z, *params = ctx.saved_tensors
        J = torch.func.jacfwd(ctx.res)(z, *params)
        live = [i for i, (p, t) in enumerate(zip(params, param_tangents))
                if t is not None and p.is_floating_point()]
        if not live:              # only the starting guess had a tangent
            return torch.zeros_like(z)

        def res_of(*ps):
            full = list(params)
            for i, p in zip(live, ps):
                full[i] = p
            return ctx.res(z, *full)

        _, rt = torch.func.jvp(res_of, tuple(params[i] for i in live),
                               tuple(param_tangents[i] for i in live))
        return -sl.solve_nopiv(J, rt)


@modules.register("prg_integrator", "IMP")
class IMP(Integrator):
    """Implicit midpoint rule with a Newton solve (omu/Omu_IntIMP.C);
    A-stable, for stiff or marginally stable models.  Sensitivities by the
    implicit function theorem (:class:`_NewtonRoot`) instead of the
    reference's propagation through the Newton solve
    (Omu_IntIMP.C:416-560)."""

    def __init__(self, newton_iters: int = 8, **kw):
        super().__init__(**kw)
        self.newton_iters = newton_iters

    def solve(self, F, kk, t0, t1, x, u):
        h = torch.as_tensor((t1 - t0) / self.steps, dtype=x.dtype,
                            device=x.device)
        kk = torch.as_tensor(kk, device=x.device)

        def res(k, xs, u, tm, h, kk):
            # k = xdot at the midpoint: k - f(x + h/2 k) = 0
            return k - self._xdot(F, kk, tm, xs + 0.5 * h * k, u)

        xs = x
        for i in range(self.steps):
            t = t0 + i * h
            k0 = self._xdot(F, kk, t, xs, u)
            k = _NewtonRoot.apply(res, self.newton_iters, k0, xs, u,
                                  t + 0.5 * h, h, kk)
            xs = xs + h * k
        return xs
