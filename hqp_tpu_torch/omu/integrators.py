"""ODE/DAE integrators with differentiable sensitivities.

Port of ``hqp_tpu/omu/integrators.py`` (reference: omu/Omu_Integrator.{h,C}
and subclasses), every integrator of the reference under its registered
name: the fixed-step ``Euler``, ``RK4``, ``IMP``, ``GRK4``, ``SDIRK``,
``BDF`` (alias ``DASPK``, with the matrix-free Newton-Krylov corrector of
``krylov=True``) and ``OdeTs``, and the adaptive ``Dopri5``, ``RKsuite``,
``RKF78``, ``GRK4Adaptive``, ``IMPAdaptive``, ``BDFAdaptive`` and
``BDFVarOrder``.  Each advances one sample period; all stages run batched
under ``torch.func.vmap``, and sensitivities come from ``torch.func.jacfwd``
*through* the integrator instead of hand-propagated sensitivity ODEs.  The
reference's ``lax.fori_loop`` over the static ``steps`` is a Python loop.
Implicit stages solve their Newton systems under :class:`_NewtonRoot` (or
:class:`_NewtonKrylov`), whose forward derivative comes from the implicit
function theorem, never from differentiating the Newton iterations (the
role of ``lax.custom_root``).

The adaptive integrators are the reference's ``lax.while_loop``\\ s.  A
Python ``while`` cannot run under ``vmap``, so each loop is a
:class:`_WhileLoop` (a ``torch.autograd.Function``) whose ``vmap`` rule
moves the batch first, so that the whole stage batch reaches ONE eager
loop.  The loop steps every lane while any lane is live and each lane
keeps its state once its own test fails, as a batched ``while_loop`` does;
each iteration reads the "any lane live" flag once
(:func:`~hqp_tpu_torch.utils.sync.host`).  Its ``jvp`` runs the loop again
and carries the Jacobian of the state in the differentiated arguments
through every step, the test evaluated on the primal, as JAX
differentiates a ``while_loop``: the step controller's derivative terms
(``err``, ``fac``, ``h``, the accepted ``t``) are kept, and a lane's values
after it has finished (BDF's ``1/h`` at ``h = 0``) are dropped by the
select, Jacobians included.  Each step's Jacobian comes from reverse mode
(``torch.func.jacrev``), so the Newton solves have a ``backward`` too; the
tangent is that Jacobian times the tangents of the arguments.
``LOOP_ITERS`` and ``LOOP_READS`` count the iterations and host reads.

The model interface is the implicit residual of the reference
(omu/Omu_Program.h continuous): F(kk, t, x, u, dx) = 0 with dx entering
linearly; explicit integrators recover xdot = F(kk, t, x, u, 0).
"""

from __future__ import annotations

import math

import torch

from hqp_tpu_torch.ops import smalllin as sl
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host

#: iterations of the adaptive loops and their host reads since import
#: (forward and derivative passes alike; reset freely by callers)
LOOP_ITERS = 0
LOOP_READS = 0


def _nan_unless_reached(t, t1, span, xs):
    """Poison a truncated adaptive integration with NaN.

    A loop that exhausts ``max_steps`` (or whose controller drives h to
    nothing) exits with t < t1; NaN propagates into the SQP layer's finite
    checks, which handle it as a failed model evaluation -- the contract
    of the reference's DASPK/ros4 failure codes."""
    reached = t >= t1 - 1e-10 * torch.abs(span) - 1e-300
    return torch.where(reached, xs, float("nan"))


class Integrator:
    """Base integrator (Omu_Integrator analog): ``stepsize`` (the first
    step of the adaptive integrators, 0 for their default), ``steps``
    fixed steps a sample period, and the adaptive integrators' ``rtol``
    and ``atol``.

    solve(F, kk, t0, t1, x, u) -> x(t1), where F is the implicit residual.
    """

    def __init__(self, stepsize: float = 0.0, steps: int = 1,
                 rtol: float = 1e-8, atol: float = 1e-8):
        self.stepsize = stepsize
        self.steps = steps
        self.rtol = rtol
        self.atol = atol

    def _xdot(self, F, kk, t, x, u):
        return F(kk, t, x, u, torch.zeros_like(x))

    def solve(self, F, kk, t0, t1, x, u):
        raise NotImplementedError


def _args(kk, t0, t1, x, u):
    """The loop arguments as tensors on x's device."""
    f = dict(dtype=x.dtype, device=x.device)
    return (torch.as_tensor(kk, device=x.device), torch.as_tensor(t0, **f),
            torch.as_tensor(t1, **f), x, u)


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


# -- the adaptive loop --------------------------------------------------------

#: dimensions of one lane of the loop arguments (kk, t0, t1, x, u)
_ARG_NDIMS = (0, 0, 0, 1, 1)


def _batch_first(info, in_dims, args):
    """The arguments with their vmap axis first (unbatched ones expanded)."""
    return tuple(a.expand(info.batch_size, *a.shape) if d is None
                 else a.movedim(d, 0) for a, d in zip(args, in_dims))


def _sel(active, new, old):
    """Lane-wise ``active ? new : old`` over two tuples of [B, ...]."""
    return tuple(torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)),
                             n, o) for n, o in zip(new, old))


class _Loop:
    """One adaptive integration as a while loop over lanes.

    ``init(args) -> state``, ``cond(state, args) -> bool``,
    ``body(state, args) -> state`` and ``out(state, args) -> x(t1)`` see
    one lane; ``args = (kk, t0, t1, x, u)`` and the state is a tuple of
    floating tensors (counters too, exact in float64), so that the whole
    state carries tangents.  ``cond=None`` is no loop: ``init`` does all
    the work (the fixed-step integrators, differentiated the same way)."""

    def __init__(self, init, cond, body, out):
        self.init, self.cond, self.body, self.out = init, cond, body, out

    @staticmethod
    def lanes(args):
        """(lead shape, the arguments flattened to [B, *lane shape])."""
        lead = torch.broadcast_shapes(*(a.shape[:a.dim() - nd]
                                        for a, nd in zip(args, _ARG_NDIMS)))
        flat = []
        for a, nd in zip(args, _ARG_NDIMS):
            lane = a.shape[a.dim() - nd:]
            flat.append(a.expand(tuple(lead) + tuple(lane))
                        .reshape((-1,) + tuple(lane)))
        return lead, tuple(flat)

    @staticmethod
    def _iterate(live, st, step):
        """Step every lane while any lane is live (``live(st)``, [B]);
        ``step(st)`` returns the new state of every lane."""
        global LOOP_ITERS, LOOP_READS
        while True:
            active = live(st)
            LOOP_READS += 1
            if not host(active.any()):
                return st
            LOOP_ITERS += 1
            st = _sel(active, step(st), st)

    def final_state(self, args):
        """The loop's last state, every lane (no transform may be live)."""
        lead, a = self.lanes(args)
        st = torch.func.vmap(self.init)(a)
        if self.cond is not None:
            cond = torch.func.vmap(self.cond)
            body = torch.func.vmap(self.body)
            st = self._iterate(lambda st: cond(st, a), st,
                               lambda st: body(st, a))
        return lead, st, a

    def run(self, args):
        lead, st, a = self.final_state(args)
        return torch.func.vmap(self.out)(st, a).reshape(
            *lead, *args[3].shape[-1:])

    def run_jac(self, args, live):
        """d x(t1) / d args[i] for i in ``live``, every lane: [*lead, nx,
        P] (the arguments' entries concatenated).  The loop runs again on
        the flattened state with its Jacobian S in those arguments,
        S <- (d body / d state) S + d body / d args, each step's Jacobians
        by ``torch.func.jacrev`` (the forward mode of a tensor with a
        Python number takes PyTorch's Python decompositions and costs
        tens of times more); the test reads the primal state."""
        lead, a = self.lanes(args)
        la = tuple(a[i] for i in live)

        def flat(st):
            return torch.cat([s.reshape(-1) for s in st])

        def full(a, la):
            f = list(a)
            for i, x in zip(live, la):
                f[i] = x
            return tuple(f)

        def lin(fn, argnums):
            """Lane-wise (Jacobians [B, m, n_k] in ``argnums``, aux) of
            fn(...) -> (value, aux)."""
            jac = torch.func.vmap(torch.func.jacrev(fn, argnums=argnums,
                                                    has_aux=True))

            def run(*xs):
                js, aux = jac(*xs)
                return [j.reshape(j.shape[:2] + (-1,)) for j in js], aux
            return run

        def twice(o):
            return o, o

        nl = len(live)
        on_args = tuple(range(2, 2 + nl))
        init = lin(lambda a, *la: (lambda st: (flat(st), st))(
            self.init(full(a, la))), tuple(range(1, 1 + nl)))
        ja, st = init(a, *la)
        shapes = [s.shape[1:] for s in st]
        sizes = [math.prod(sh) for sh in shapes]

        def unflat(v):
            return tuple(p.reshape(sh)
                         for p, sh in zip(torch.split(v, sizes), shapes))

        v = torch.cat([s.reshape(s.shape[0], -1) for s in st], dim=1)
        S = torch.cat(ja, dim=-1)
        if self.cond is not None:
            body = lin(lambda v, a, *la: twice(
                flat(self.body(unflat(v), full(a, la)))), (0,) + on_args)
            cond = torch.func.vmap(lambda v, a: self.cond(unflat(v), a))

            def step(st):
                (jv, *ja), vn = body(st[0], a, *la)
                return vn, jv @ st[1] + torch.cat(ja, dim=-1)

            v, S = self._iterate(lambda st: cond(st[0], a), (v, S), step)
        out = lin(lambda v, a, *la: twice(self.out(unflat(v), full(a, la))),
                  (0,) + on_args)
        (jv, *ja), _ = out(v, a, *la)
        J = jv @ S + torch.cat(ja, dim=-1)
        return J.reshape(tuple(lead) + J.shape[1:])


class _WhileLoop(torch.autograd.Function):
    """x(t1) of a :class:`_Loop` on any leading axes of its arguments."""

    @staticmethod
    def forward(loop, *args):
        return loop.run(args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.loop = inputs[0]
        ctx.save_for_forward(*inputs[1:])

    @staticmethod
    def jvp(ctx, _loop_t, *tangents):
        args = ctx.saved_tensors
        live = tuple(i for i, (a, t) in enumerate(zip(args, tangents))
                     if t is not None and a.is_floating_point())
        if not live:
            return torch.zeros_like(args[3])
        J = _WhileLoopJac.apply(ctx.loop, live, *args)
        lead = J.shape[:-2]
        dt = torch.cat([tangents[i].expand(
            tuple(lead) + args[i].shape[args[i].dim() - _ARG_NDIMS[i]:])
            .reshape(tuple(lead) + (-1,)) for i in live], dim=-1)
        return (J @ dt[..., None])[..., 0]

    @staticmethod
    def vmap(info, in_dims, loop, *args):
        return _WhileLoop.apply(loop, *_batch_first(info, in_dims[1:],
                                                    args)), 0


class _WhileLoopJac(torch.autograd.Function):
    """The Jacobian of a :class:`_WhileLoop` in the arguments ``live``
    (:meth:`_Loop.run_jac`); it has no derivative of its own.  Called with
    the primal arguments alone, so a ``jacfwd`` basis never reaches it."""

    @staticmethod
    def forward(loop, live, *args):
        return loop.run_jac(args, live)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError("adaptive integrator: no second derivative (the "
                           "loop's Jacobian is not differentiable)")

    @staticmethod
    def vmap(info, in_dims, loop, live, *args):
        return _WhileLoopJac.apply(loop, live, *_batch_first(
            info, in_dims[2:], args)), 0


def _run_loop(init, cond, body, out, kk, t0, t1, x, u):
    """x(t1) of the loop (init, cond, body, out) from these arguments."""
    return _WhileLoop.apply(_Loop(init, cond, body, out),
                            *_args(kk, t0, t1, x, u))


def _fixed(lane, kk, t0, t1, x, u):
    """x(t1) = lane(args) of a fixed-step integration (one lane of
    ``args = (kk, t0, t1, x, u)``) as a :class:`_WhileLoop` without a
    loop, so that its derivative too comes from reverse mode."""
    return _run_loop(lambda a: (lane(a),), None, None, lambda st, a: st[0],
                     kk, t0, t1, x, u)


def _scaled_err(e, a, b, rtol, atol):
    """The reference's RMS error norm of e against max(|a|, |b|)."""
    return torch.sqrt(torch.mean(
        (e / (atol + rtol * torch.maximum(torch.abs(a), torch.abs(b)))) ** 2)
        + 1e-300)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: a max and a min, whose derivatives split
    at a tie (``torch.clamp``'s do not)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _live(t, t1, span, n, max_steps):
    return (t < t1 - 1e-12 * torch.abs(span)) & (n < max_steps)


def _h0(stepsize, span, div):
    """The first step: ``stepsize`` (a tensor like span's, without a
    tangent) if set, else span / div."""
    return span * 0.0 + stepsize if stepsize > 0.0 else span / div


# Dormand-Prince 5(4) tableau (same pair as omu/Omu_IntDopri5.C, the
# Hairer/Wanner dopri5 port)
_DP_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40]

# Bogacki-Shampine 3(2) pair (the low-order pair offered by the
# reference's rksuite wrapper, omu/Omu_IntRKsuite.C method=1)
_BS_C = [0.0, 1 / 2, 3 / 4, 1.0]
_BS_A = [
    [],
    [1 / 2],
    [0.0, 3 / 4],
    [2 / 9, 1 / 3, 4 / 9],
]
_BS_B3 = [2 / 9, 1 / 3, 4 / 9, 0.0]
_BS_B2 = [7 / 24, 1 / 4, 1 / 3, 1 / 8]


class _EmbeddedRK(Integrator):
    """Adaptive embedded RK pair with step control, as a
    :class:`_WhileLoop`.  Subclasses supply the tableau."""

    C = _DP_C
    A = _DP_A
    BHI = _DP_B5
    BLO = _DP_B4
    ERR_ORDER = 5.0  # exponent base for step control

    def __init__(self, max_steps: int = 1000, **kw):
        super().__init__(**kw)
        self.max_steps = max_steps

    def solve(self, F, kk, t0, t1, x, u):
        rtol, atol = self.rtol, self.atol
        C, A = self.C, self.A

        def fstep(kk, t, xs, h, u):
            ks = []
            for i in range(len(A)):
                xi = xs
                for j, a in enumerate(A[i]):
                    xi = xi + h * a * ks[j]
                ks.append(self._xdot(F, kk, t + C[i] * h, xi, u))
            kmat = torch.stack(ks)
            bhi, blo = (torch.tensor(b, dtype=xs.dtype, device=xs.device)
                        for b in (self.BHI, self.BLO))
            xhi = xs + h * (bhi @ kmat)
            xlo = xs + h * (blo @ kmat)
            return xhi, _scaled_err(xhi - xlo, xs, xhi, rtol, atol)

        def init(a):
            kk, t0, t1, x, u = a
            return (t0, x, _h0(self.stepsize, t1 - t0, 10.0), t0 * 0.0)

        def cond(st, a):
            t, xs, h, n = st
            return _live(t, a[2], a[2] - a[1], n, self.max_steps)

        def body(st, a):
            kk, t0, t1, x, u = a
            t, xs, h, n = st
            h = torch.minimum(h, t1 - t)
            xhi, err = fstep(kk, t, xs, h, u)
            accept = err <= 1.0
            fac = _clip(0.9 * err ** (-1.0 / self.ERR_ORDER), 0.2, 5.0)
            return (torch.where(accept, t + h, t),
                    torch.where(accept, xhi, xs), h * fac, n + 1)

        def out(st, a):
            return _nan_unless_reached(st[0], a[2], a[2] - a[1], st[1])

        return _run_loop(init, cond, body, out, kk, t0, t1, x, u)


@modules.register("prg_integrator", "Dopri5")
class Dopri5(_EmbeddedRK):
    """Adaptive Dormand-Prince RK45 (omu/Omu_IntDopri5.C)."""


@modules.register("prg_integrator", "RKsuite")
class RKsuite(_EmbeddedRK):
    """Adaptive RK-pair family in the role of the reference's Fortran
    rksuite wrapper (omu/Omu_IntRKsuite.{h,C}): ``method=2`` selects the
    Bogacki-Shampine 3(2) pair, ``method=4`` (default) the Dormand-Prince
    5(4) pair."""

    def __init__(self, method: int = 4, **kw):
        super().__init__(**kw)
        self.method = method
        if method <= 2:
            self.C, self.A = _BS_C, _BS_A
            self.BHI, self.BLO = _BS_B3, _BS_B2
            self.ERR_ORDER = 3.0


# Fehlberg 7(8) tableau (the high-order pair rksuite offers as method 3,
# rksuite/rksuite.f RK(7,8)); 13 stages, 7th-order solution with an
# 8th-order error estimator
_F78_C = [0.0, 2 / 27, 1 / 9, 1 / 6, 5 / 12, 1 / 2, 5 / 6, 1 / 6, 2 / 3,
          1 / 3, 1.0, 0.0, 1.0]
_F78_A = [
    [],
    [2 / 27],
    [1 / 36, 1 / 12],
    [1 / 24, 0.0, 1 / 8],
    [5 / 12, 0.0, -25 / 16, 25 / 16],
    [1 / 20, 0.0, 0.0, 1 / 4, 1 / 5],
    [-25 / 108, 0.0, 0.0, 125 / 108, -65 / 27, 125 / 54],
    [31 / 300, 0.0, 0.0, 0.0, 61 / 225, -2 / 9, 13 / 900],
    [2.0, 0.0, 0.0, -53 / 6, 704 / 45, -107 / 9, 67 / 90, 3.0],
    [-91 / 108, 0.0, 0.0, 23 / 108, -976 / 135, 311 / 54, -19 / 60,
     17 / 6, -1 / 12],
    [2383 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -301 / 82,
     2133 / 4100, 45 / 82, 45 / 164, 18 / 41],
    [3 / 205, 0.0, 0.0, 0.0, 0.0, -6 / 41, -3 / 205, -3 / 41, 3 / 41,
     6 / 41, 0.0],
    [-1777 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -289 / 82,
     2193 / 4100, 51 / 82, 33 / 164, 12 / 41, 0.0, 1.0],
]
_F78_B7 = [41 / 840, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35,
           9 / 280, 9 / 280, 41 / 840, 0.0, 0.0]
_F78_B8 = [0.0, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35, 9 / 280,
           9 / 280, 0.0, 41 / 840, 41 / 840]


@modules.register("prg_integrator", "RKF78")
class RKF78(_EmbeddedRK):
    """Adaptive Fehlberg 7(8) pair -- the reference's rksuite high-order
    method (omu/Omu_IntRKsuite.C method 3 over rksuite/rksuite.f)."""

    C = _F78_C
    A = _F78_A
    BHI = _F78_B8   # propagate the 8th-order solution (local extrap.)
    BLO = _F78_B7
    ERR_ORDER = 8.0


# -- Newton solves with implicit-function-theorem derivatives -----------------


class _NewtonRoot(torch.autograd.Function):
    """z* with res(z*, *params) = 0 by ``iters`` undamped Newton steps
    from z0, differentiated by the implicit function theorem:
    dz = -J^-1 (d res / d params) dparams with J = d res / dz at z*, both
    solved by the pivot-free LU as the reference's ``tangent_solve`` does.
    ``params`` are tensors (the residual's only inputs besides z); integer
    ones carry no tangent.  It runs under the stage ``vmap`` and ``jacfwd``
    of ``Docp.eval_derivs`` (``jvp``) and inside an adaptive loop's
    Jacobian steps (``backward``).  J comes from ``torch.func.jacrev``,
    several times cheaper here than ``jacfwd`` and equal to rounding."""

    generate_vmap_rule = True

    @staticmethod
    def forward(res, iters, z0, *params):
        z = z0
        for _ in range(iters):
            J = torch.func.jacrev(res)(z, *params)
            z = z - sl.solve_nopiv(J, res(z, *params))
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.res = inputs[0]
        ctx.save_for_forward(output, *inputs[3:])
        ctx.save_for_backward(output, *inputs[3:])

    @staticmethod
    def jvp(ctx, _res_t, _iters_t, _z0_t, *param_tangents):
        z, *params = ctx.saved_tensors
        rt = _param_jvp(ctx.res, z, params, param_tangents)
        if rt is None:            # only the starting guess had a tangent
            return torch.zeros_like(z)
        J = torch.func.jacrev(ctx.res)(z, *params)
        return -sl.solve_nopiv(J, rt)

    @staticmethod
    def backward(ctx, g):
        """The same theorem transposed: J' lam = g, then the parameters'
        cotangents -(d res / d params)' lam (an adaptive loop's Jacobian
        steps, :meth:`_Loop.run_jac`)."""
        z, *params = ctx.saved_tensors
        J = torch.func.jacrev(ctx.res)(z, *params)
        lam = sl.solve_nopiv(J.transpose(-1, -2), g)
        return (None, None, None, *_param_vjp(ctx.res, z, params, -lam))


def _param_jvp(res, z, params, tangents):
    """d res(z, *params) along the parameters' tangents (None if none)."""
    live = [i for i, (p, t) in enumerate(zip(params, tangents))
            if t is not None and p.is_floating_point()]
    if not live:
        return None

    def res_of(*ps):
        full = list(params)
        for i, p in zip(live, ps):
            full[i] = p
        return res(z, *full)

    return torch.func.jvp(res_of, tuple(params[i] for i in live),
                          tuple(tangents[i] for i in live))[1]


def _param_vjp(res, z, params, cot):
    """The cotangents of the parameters of res(z, *params) for ``cot``
    (None for the integer ones)."""
    live = [i for i, p in enumerate(params) if p.is_floating_point()]

    def res_of(*ps):
        full = list(params)
        for i, p in zip(live, ps):
            full[i] = p
        return res(z, *full)

    grads = torch.func.vjp(res_of, *(params[i] for i in live))[1](cot)
    out = [None] * len(params)
    for i, g in zip(live, grads):
        out[i] = g
    return out


def _cho_pos(a, b):
    """a^-1 b for a small SPD ``a``, by an unrolled Cholesky (NaN where
    ``a`` is not SPD, as ``jax.scipy.linalg.solve(assume_a='pos')``)."""
    n = a.shape[-1]
    cols = []
    for j in range(n):
        v = a[j:, j]
        for k in range(j):
            v = v - cols[k][j - k:] * cols[k][j - k]
        d = torch.sqrt(v[0])
        cols.append(torch.cat([d[None], v[1:] / d]))
    L = torch.stack([torch.cat([a.new_zeros(j), c])
                     for j, c in enumerate(cols)], dim=1)
    return sl.cho_solve(L, b)


def _safe_normalize(x, thresh=None):
    norm = torch.sqrt(torch.dot(x, x))
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    return (torch.where(use, x / norm, 0.0), torch.where(use, norm, 0.0))


def gmres(A, b, restart=20, maxiter=2):
    """x with A(x) = b by restarted GMRES, the arithmetic of
    ``jax.scipy.sparse.linalg.gmres(A, b, restart=restart, maxiter=
    maxiter, tol=0.0, atol=0.0)`` with its default ``solve_method=
    'batched'``: from x0 = 0, each restart builds the Arnoldi basis of
    ``min(restart, n)`` vectors by one classical Gram-Schmidt pass, solves
    the Hessenberg least-squares problem through its normal equations
    (Cholesky), and ``maxiter`` restarts run unless the residual is
    exactly 0.  The loops are unrolled with selects, so that it runs under
    ``vmap`` and ``jvp``; ``A`` maps one vector of b's shape to another."""
    n = b.shape[-1]
    restart = min(restart, n)
    eps = torch.finfo(b.dtype).eps
    x = torch.zeros_like(b)
    unit, rnorm = _safe_normalize(b - A(x))
    for _ in range(maxiter):
        go = rnorm > 0.0
        V = torch.cat([unit[:, None], b.new_zeros(n, restart)], dim=1)
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        broken = torch.zeros((), dtype=torch.bool, device=b.device)
        for k in range(restart):
            v = A(V[:, k])
            _, vnorm0 = _safe_normalize(v)
            h = V.T @ v
            v = v - V @ h
            unit_v, vnorm1 = _safe_normalize(v, thresh=eps * vnorm0)
            Vn = torch.cat([V[:, :k + 1], unit_v[:, None], V[:, k + 2:]],
                           dim=1)
            h = torch.cat([h[:k + 1], vnorm1[None], h[k + 2:]])
            Hn = torch.cat([H[:k], h[None], H[k + 1:]], dim=0)
            V = torch.where(broken, V, Vn)
            H = torch.where(broken, H, Hn)
            broken = broken | (vnorm1 == 0.0)
        beta = torch.cat([rnorm[None], b.new_zeros(restart)])
        y = _cho_pos(H @ H.T, H @ beta)
        xn = x + V[:, :-1] @ y
        un, rn = _safe_normalize(b - A(xn))
        x = torch.where(go, xn, x)
        unit = torch.where(go, un, unit)
        rnorm = torch.where(go, rn, rnorm)
    return x


class _NewtonKrylov(torch.autograd.Function):
    """:class:`_NewtonRoot` with matrix-free corrections: each Newton step
    and the tangent solve are :func:`gmres` over J v products by
    ``torch.func.jvp`` (``restart``, two restarts, no tolerance), the
    DASPK Krylov option (omu/Omu_IntDASPK.h:112-119 ``_krylov``, DASPK
    ``info[12]=1``) as the reference's ``_newton_root_krylov`` runs it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(res, iters, restart, z0, *params):
        z = z0
        for _ in range(iters):
            zk = z

            def mv(v):
                return torch.func.jvp(lambda zz: res(zz, *params),
                                      (zk,), (v,))[1]

            z = z - gmres(mv, res(zk, *params), restart)
        return z

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.res, ctx.restart = inputs[0], inputs[2]
        ctx.save_for_forward(output, *inputs[4:])
        ctx.save_for_backward(output, *inputs[4:])

    @staticmethod
    def jvp(ctx, _res_t, _iters_t, _restart_t, _z0_t, *param_tangents):
        z, *params = ctx.saved_tensors
        rt = _param_jvp(ctx.res, z, params, param_tangents)
        if rt is None:
            return torch.zeros_like(z)

        def mv(v):
            return torch.func.jvp(lambda zz: ctx.res(zz, *params),
                                  (z,), (v,))[1]

        return -gmres(mv, rt, ctx.restart)

    @staticmethod
    def backward(ctx, g):
        """:meth:`_NewtonRoot.backward` with J' v products by
        ``torch.func.vjp`` and :func:`gmres` for J' lam = g."""
        z, *params = ctx.saved_tensors
        mvt = torch.func.vjp(lambda zz: ctx.res(zz, *params), z)[1]
        lam = gmres(lambda v: mvt(v)[0], g, ctx.restart)
        return (None, None, None, None,
                *_param_vjp(ctx.res, z, params, -lam))


# -- implicit fixed-step integrators ------------------------------------------


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

    def _imp_step(self, F, kk, t, xs, u, h):
        """One midpoint step of size h from (t, xs)."""
        def res(k, xs, u, tm, h, kk):
            # k = xdot at the midpoint: k - f(x + h/2 k) = 0
            return k - self._xdot(F, kk, tm, xs + 0.5 * h * k, u)

        k0 = self._xdot(F, kk, t, xs, u)
        k = _NewtonRoot.apply(res, self.newton_iters, k0, xs, u,
                              t + 0.5 * h, h, kk)
        return xs + h * k

    def solve(self, F, kk, t0, t1, x, u):
        h = torch.as_tensor((t1 - t0) / self.steps, dtype=x.dtype,
                            device=x.device)
        kk = torch.as_tensor(kk, device=x.device)
        xs = x
        for i in range(self.steps):
            xs = self._imp_step(F, kk, t0 + i * h, xs, u, h)
        return xs


# Shampine's Rosenbrock parameters (Numerical Recipes "stiff"), the same
# linear-implicit 4th-order family as the reference's ros4.f port
# (omu/Omu_IntGRK4.C), with the embedded 3rd-order error estimator
_RB_GAM = 0.5
_RB_A21 = 2.0
_RB_A31, _RB_A32 = 48.0 / 25.0, 6.0 / 25.0
_RB_C21 = -8.0
_RB_C31, _RB_C32 = 372.0 / 25.0, 12.0 / 5.0
_RB_C41, _RB_C42, _RB_C43 = -112.0 / 125.0, -54.0 / 125.0, -2.0 / 5.0
_RB_B1, _RB_B2, _RB_B3, _RB_B4 = 19.0 / 9.0, 0.5, 25.0 / 108.0, 125.0 / 108.0
_RB_E1, _RB_E2, _RB_E3, _RB_E4 = 17.0 / 54.0, 7.0 / 36.0, 0.0, 125.0 / 108.0
_RB_C1X, _RB_C2X, _RB_C3X, _RB_C4X = 0.5, -1.5, 121.0 / 50.0, 29.0 / 250.0
_RB_A2X, _RB_A3X = 1.0, 3.0 / 5.0


@modules.register("prg_integrator", "GRK4")
class GRK4(Integrator):
    """4th-order linear-implicit Rosenbrock (Shampine parameters), the
    role of omu/Omu_IntGRK4.C for stiff systems: one Jacobian and one
    factorization a step, no Newton iteration.  Fixed steps; the embedded
    step control is :class:`GRK4Adaptive`."""

    def _rb_step(self, F, kk, t, xs, u, h):
        """One Rosenbrock step -> (x4, embedded error vector)."""
        n = xs.shape[0]

        def f_of(xx, tt):
            return self._xdot(F, kk, tt, xx, u)

        J, dfdt = torch.func.jacrev(f_of, argnums=(0, 1))(xs, t)
        M = torch.eye(n, dtype=xs.dtype, device=xs.device) \
            / (_RB_GAM * h) - J
        lu = sl.lu_nopiv(M)

        g1 = sl.lu_nopiv_solve(lu, f_of(xs, t) + h * _RB_C1X * dfdt)
        g2 = sl.lu_nopiv_solve(
            lu, f_of(xs + _RB_A21 * g1, t + _RB_A2X * h)
            + h * _RB_C2X * dfdt + _RB_C21 * g1 / h)
        x3 = xs + _RB_A31 * g1 + _RB_A32 * g2
        g3 = sl.lu_nopiv_solve(
            lu, f_of(x3, t + _RB_A3X * h) + h * _RB_C3X * dfdt
            + (_RB_C31 * g1 + _RB_C32 * g2) / h)
        g4 = sl.lu_nopiv_solve(
            lu, f_of(x3, t + _RB_A3X * h) + h * _RB_C4X * dfdt
            + (_RB_C41 * g1 + _RB_C42 * g2 + _RB_C43 * g3) / h)
        x4 = xs + _RB_B1 * g1 + _RB_B2 * g2 + _RB_B3 * g3 + _RB_B4 * g4
        err = _RB_E1 * g1 + _RB_E2 * g2 + _RB_E3 * g3 + _RB_E4 * g4
        return x4, err

    def solve(self, F, kk, t0, t1, x, u):
        def lane(a):
            kk, t0, t1, x, u = a
            h = (t1 - t0) / self.steps
            xs = x
            for i in range(self.steps):
                xs, _ = self._rb_step(F, kk, t0 + i * h, xs, u, h)
            return xs

        return _fixed(lane, kk, t0, t1, x, u)


@modules.register("prg_integrator", "GRK4Adaptive")
class GRK4Adaptive(GRK4):
    """Rosenbrock with the embedded step control of the reference's ros4.f
    port (omu/Omu_IntGRK4.C, the NR 'stiff' routine): the 3rd-order embedded
    solution gives the local error, steps shrink as err^(-1/3) on
    rejection and grow as err^(-1/4) on acceptance, as a
    :class:`_WhileLoop`."""

    def __init__(self, max_steps: int = 2000, **kw):
        super().__init__(**kw)
        self.max_steps = max_steps

    def solve(self, F, kk, t0, t1, x, u):
        rtol, atol = self.rtol, self.atol

        def init(a):
            kk, t0, t1, x, u = a
            return (t0, x, _h0(self.stepsize, t1 - t0, 4.0), t0 * 0.0)

        def cond(st, a):
            t, xs, h, n = st
            return _live(t, a[2], a[2] - a[1], n, self.max_steps)

        def body(st, a):
            kk, t0, t1, x, u = a
            t, xs, h, n = st
            h = torch.minimum(h, t1 - t)
            xn, ev = self._rb_step(F, kk, t, xs, u, h)
            err = _scaled_err(ev, xs, xn, rtol, atol)
            accept = err <= 1.0
            fac = torch.where(
                accept, _clip(0.9 * err ** (-0.25), 1.0, 5.0),
                _clip(0.9 * err ** (-1.0 / 3.0), 0.1, 1.0))
            return (torch.where(accept, t + h, t),
                    torch.where(accept, xn, xs), h * fac, n + 1)

        def out(st, a):
            return _nan_unless_reached(st[0], a[2], a[2] - a[1], st[1])

        return _run_loop(init, cond, body, out, kk, t0, t1, x, u)


# Alexander's 3-stage, 3rd-order, L-stable, stiffly accurate SDIRK
# coefficients (gamma = middle root of x^3 - 3x^2 + 3x/2 - 1/6)
_SD_GAMMA = 0.4358665215084590
_SD_C2 = (1.0 + _SD_GAMMA) / 2.0
_SD_A21 = (1.0 - _SD_GAMMA) / 2.0
_SD_B1 = -1.5 * _SD_GAMMA * _SD_GAMMA + 4.0 * _SD_GAMMA - 0.25
_SD_B2 = 1.5 * _SD_GAMMA * _SD_GAMMA - 5.0 * _SD_GAMMA + 1.25


@modules.register("prg_integrator", "SDIRK")
class SDIRK(Integrator):
    """Singly diagonally implicit Runge-Kutta for implicit DAEs
    F(x, xdot, u) = 0 (role of omu/Omu_IntSDIRK.{h,C}): Alexander's
    3-stage L-stable, stiffly accurate order-3 method.  Each stage
    derivative k_i solves F(t_i, x + h*sum a_ij k_j, u, k_i) = 0 by
    Newton (:class:`_NewtonRoot`); index-1 DAEs need no marking of their
    algebraic states, since the stage Jacobian gamma*h*dF/dx + dF/dxdot
    stays regular, and stiff accuracy ends each step on the algebraic
    manifold."""

    def __init__(self, newton_iters: int = 8, **kw):
        super().__init__(**kw)
        self.newton_iters = newton_iters

    def solve(self, F, kk, t0, t1, x, u):
        g = _SD_GAMMA

        def res(k, base, u, ti, h, kk):
            return F(kk, ti, base + h * g * k, u, k)

        def lane(a):
            kk, t0, t1, x, u = a
            h = (t1 - t0) / self.steps

            def stage(t_i, base):
                return _NewtonRoot.apply(res, self.newton_iters,
                                         torch.zeros_like(x), base, u, t_i,
                                         h, kk)

            xs = x
            for i in range(self.steps):
                t = t0 + i * h
                k1 = stage(t + g * h, xs)
                k2 = stage(t + _SD_C2 * h, xs + h * _SD_A21 * k1)
                k3 = stage(t + h, xs + h * (_SD_B1 * k1 + _SD_B2 * k2))
                # stiffly accurate: x+ = the last stage value
                xs = xs + h * (_SD_B1 * k1 + _SD_B2 * k2 + g * k3)
            return xs

        return _fixed(lane, kk, t0, t1, x, u)


@modules.register("prg_integrator", "DASPK")
@modules.register("prg_integrator", "BDF")
class BDF(Integrator):
    """Fixed-leading-coefficient BDF for implicit DAEs F(x, xdot, u) = 0,
    the role of the reference's DASPK 3.0 interface (omu/Omu_IntDASPK.
    {h,C}): BDF2 (or BDF1 with ``order=1``) with a BDF1 starter; each step
    solves F(t_{n+1}, x_{n+1}, u, (a0 x_{n+1} - rhs)/h) = 0 for x_{n+1} by
    Newton, differentiated by the implicit function theorem.
    ``krylov=True`` (DASPK ``info[12]=1``) solves the Newton corrections
    by GMRES over J v products (:class:`_NewtonKrylov`), also in the
    adaptive subclasses."""

    def __init__(self, newton_iters: int = 8, order: int = 2,
                 krylov: bool = False, krylov_restart: int = 20, **kw):
        # DASPK is an adaptive multistep code: one fixed step a sample
        # period would be implicit Euler, so a few substeps by default
        kw.setdefault("steps", 4)
        super().__init__(**kw)
        self.newton_iters = newton_iters
        self.order = order
        self.krylov = krylov
        self.krylov_restart = krylov_restart

    def _implicit_step(self, F, kk, t_next, x_pred, a0_h, hist, u):
        """Solve F(t, x, u, a0_h*x - hist) = 0 for x from x_pred."""

        def res(xn, t_next, a0_h, hist, u, kk):
            return F(kk, t_next, xn, u, a0_h * xn - hist)

        params = (t_next, a0_h, hist, u, kk)
        if self.krylov:
            return _NewtonKrylov.apply(res, self.newton_iters,
                                       self.krylov_restart, x_pred, *params)
        return _NewtonRoot.apply(res, self.newton_iters, x_pred, *params)

    def solve(self, F, kk, t0, t1, x, u):
        return _fixed(lambda a: self._fixed_steps(F, *a), kk, t0, t1, x, u)

    def _fixed_steps(self, F, kk, t0, t1, x, u):
        h = (t1 - t0) / self.steps
        # BDF1 starter: xdot = (x1 - x0)/h
        x1 = self._implicit_step(F, kk, t0 + h, x, 1.0 / h, x / h, u)
        if self.order == 1:
            xs = x1
            for i in range(self.steps - 1):
                t = t0 + (i + 1) * h
                xs = self._implicit_step(F, kk, t + h, xs, 1.0 / h, xs / h,
                                         u)
            return xs
        # BDF2: xdot = (3 x_{n+1} - 4 x_n + x_{n-1}) / (2h)
        xm1, xn = x, x1
        for i in range(self.steps - 1):
            t_next = t0 + (i + 2) * h
            hist = (4.0 * xn - xm1) / (2.0 * h)
            xp = 2.0 * xn - xm1  # linear predictor
            xm1, xn = xn, self._implicit_step(F, kk, t_next, xp, 1.5 / h,
                                              hist, u)
        return xn


def _taylor_terms(f, xs, order):
    """The reference's Taylor terms cs of OdeTs: cs[0] = f(xs) and
    cs[k] = d^k/ds^k f(xs + sum_j cs[j-1] s^j / j!) at s = 0, over
    (k + 1) -- what ``jax.experimental.jet`` returns there, which takes
    and gives derivatives, not coefficients -- by k nested
    ``torch.func.jvp`` in the scalar s.  The polynomial is in Horner form,
    so that no power of s = 0 is differentiated."""
    cs = [f(xs)]
    for k in range(1, order):
        coef = [c / math.factorial(j + 1) for j, c in enumerate(cs)]

        def g(s, coef=coef):
            p = coef[-1]
            for c in reversed(coef[:-1]):
                p = c + s * p
            return f(xs + s * p)

        d = g
        for _ in range(k):
            d = (lambda fn: lambda s: torch.func.jvp(
                fn, (s,), (torch.ones_like(s),))[1])(d)
        cs.append(d(xs.new_zeros(())) / (k + 1))
    return cs


@modules.register("prg_integrator", "OdeTs")
class OdeTs(Integrator):
    """Taylor-series integration of autonomous ODEs (role of
    omu/Omu_IntOdeTs.{h,C}, which uses ADOL-C's forodec higher-order
    forward mode): each step sums the Taylor terms of
    :func:`_taylor_terms`; like the reference, t is frozen at the step's
    start within a step."""

    def __init__(self, order: int = 6, **kw):
        super().__init__(**kw)
        self.order = order

    def solve(self, F, kk, t0, t1, x, u):
        h = (t1 - t0) / self.steps
        xs = x
        for i in range(self.steps):
            t = t0 + i * h
            out, hp = xs, h
            for c in _taylor_terms(
                    lambda z, t=t: self._xdot(F, kk, t, z, u), xs,
                    self.order):
                out = out + c * hp
                hp = hp * h
            xs = out
        return xs


# -- the adaptive implicit integrators ----------------------------------------


@modules.register("prg_integrator", "IMPAdaptive")
class IMPAdaptive(IMP):
    """Implicit midpoint with Richardson step control
    (omu/Omu_IntIMP.C:379-385): each step compares one h-step against two
    h/2-steps; the extrapolated value (order 3) is propagated and the
    error estimate ||x_2h/2 - x_h|| / 3 drives the step size, as a
    :class:`_WhileLoop`."""

    def __init__(self, max_steps: int = 1000, **kw):
        super().__init__(**kw)
        self.max_steps = max_steps

    def solve(self, F, kk, t0, t1, x, u):
        rtol, atol = self.rtol, self.atol

        def init(a):
            kk, t0, t1, x, u = a
            return (t0, x, _h0(self.stepsize, t1 - t0, 4.0), t0 * 0.0)

        def cond(st, a):
            t, xs, h, n = st
            return _live(t, a[2], a[2] - a[1], n, self.max_steps)

        def body(st, a):
            kk, t0, t1, x, u = a
            t, xs, h, n = st
            h = torch.minimum(h, t1 - t)
            x1 = self._imp_step(F, kk, t, xs, u, h)
            xh = self._imp_step(F, kk, t, xs, u, 0.5 * h)
            x2 = self._imp_step(F, kk, t + 0.5 * h, xh, u, 0.5 * h)
            # midpoint rule is order 2: Richardson error and extrapolant
            diff = (x2 - x1) / 3.0
            err = _scaled_err(diff, xs, x2, rtol, atol)
            accept = err <= 1.0
            fac = _clip(0.9 * err ** (-1.0 / 3.0), 0.2, 5.0)
            return (torch.where(accept, t + h, t),
                    torch.where(accept, x2 + diff, xs), h * fac, n + 1)

        def out(st, a):
            return _nan_unless_reached(st[0], a[2], a[2] - a[1], st[1])

        return _run_loop(init, cond, body, out, kk, t0, t1, x, u)


def _start_step(it, span):
    """The BDF starter's step: span * sqrt(rtol) (its O(h^2) local error
    enters the global error unreduced), at most ``stepsize``."""
    hs = span * math.sqrt(max(it.rtol, 1e-14))
    if it.stepsize > 0.0:
        hs = torch.minimum(hs, torch.full_like(hs, it.stepsize))
    return hs


@modules.register("prg_integrator", "BDFAdaptive")
class BDFAdaptive(BDF):
    """Variable-step BDF2 with predictor-corrector error control -- the
    adaptive-multistep role of DASPK (omu/Omu_IntDASPK.C): variable-step
    BDF2 coefficients over the steps (h, h_prev), a linear-extrapolation
    predictor and the local error ||corrector - predictor|| / 3, as a
    :class:`_WhileLoop` after a BDF1 starter step.  (Order 2: size
    ``max_steps`` for the tolerance -- h ~ rtol^(1/3).)"""

    def __init__(self, max_steps: int = 20000, **kw):
        super().__init__(**kw)
        self.max_steps = max_steps

    def solve(self, F, kk, t0, t1, x, u):
        rtol, atol = self.rtol, self.atol

        def init(a):
            kk, t0, t1, x, u = a
            hs = _start_step(self, t1 - t0)
            x1 = self._implicit_step(F, kk, t0 + hs, x, 1.0 / hs, x / hs, u)
            return (t0 + hs, x, x1, hs, hs, t0 * 0.0)

        def cond(st, a):
            return _live(st[0], a[2], a[2] - a[1], st[5], self.max_steps)

        def body(st, a):
            kk, t0, t1, x, u = a
            t, xm1, xn, h, hp, n = st
            h = torch.minimum(h, t1 - t)
            # variable-step BDF2: x'(t_{n+1}) = a0 x_{n+1} - hist
            a0 = 1.0 / h + 1.0 / (h + hp)
            hist = (h + hp) / (h * hp) * xn - h / (hp * (h + hp)) * xm1
            xp = xn + (xn - xm1) * (h / hp)          # predictor
            xc = self._implicit_step(F, kk, t + h, xp, a0, hist, u)
            diff = (xc - xp) / 3.0
            err = _scaled_err(diff, xn, xc, rtol, atol)
            accept = err <= 1.0
            fac = _clip(0.9 * err ** (-1.0 / 3.0), 0.2, 2.5)
            return (torch.where(accept, t + h, t),
                    torch.where(accept, xn, xm1),
                    torch.where(accept, xc, xn), h * fac,
                    torch.where(accept, h, hp), n + 1)

        def out(st, a):
            return _nan_unless_reached(st[0], a[2], a[2] - a[1], st[2])

        return _run_loop(init, cond, body, out, kk, t0, t1, x, u)


@modules.register("prg_integrator", "BDFVarOrder")
class BDFVarOrder(BDF):
    """Variable-order, variable-step BDF(1..3) -- the adaptive-multistep
    role of DASPK (omu/Omu_IntDASPK.C; DASPK 3.0 selects the BDF order per
    step).  A four-point history with per-interval steps supports orders
    1-3 with variable-step Lagrange coefficients; each step makes one
    implicit solve at the current order, then compares the per-order
    predictor residuals e_j = ||xc - xp_j|| (Shampine's heuristic) and
    moves the order by at most one toward the largest permissible step
    factor (1/e_j)^(1/(j+1)), as a :class:`_WhileLoop`.  The order and
    the counters are float64 state (exact), so that the whole state
    carries tangents."""

    def __init__(self, max_steps: int = 20000, max_order: int = 3, **kw):
        super().__init__(**kw)
        self.max_steps = max_steps
        self.max_order = max_order

    @staticmethod
    def _lagrange_dot_weights(taus, t_at):
        """w_j = l_j'(t_at) for nodes taus (list of scalars)."""
        m = len(taus)
        ws = []
        for j in range(m):
            total = 0.0
            for i in range(m):
                if i == j:
                    continue
                term = 1.0 / (taus[j] - taus[i])
                for q in range(m):
                    if q in (i, j):
                        continue
                    term = term * (t_at - taus[q]) / (taus[j] - taus[q])
                total = total + term
            ws.append(total)
        return ws

    @staticmethod
    def _lagrange_weights(taus, t_at):
        """w_j = l_j(t_at) (extrapolation weights)."""
        m = len(taus)
        ws = []
        for j in range(m):
            term = 1.0
            for q in range(m):
                if q == j:
                    continue
                term = term * (t_at - taus[q]) / (taus[j] - taus[q])
            ws.append(term)
        return ws

    def _loop_parts(self, F):
        """(init, cond, body, out) of the loop; the state is (t, X [4, n]
        newest last, hh [3] intervals newest last, k, h, nh, nstep)."""
        rtol, atol = self.rtol, self.atol
        kmax = min(3, self.max_order)

        def scaled(e, a, b):
            return _scaled_err(e, a, b, rtol, atol)

        def init(a):
            kk, t0, t1, x, u = a
            hs0 = _start_step(self, t1 - t0)
            zero = t0 * 0.0
            return (t0, x[None].repeat(4, 1), hs0.expand(3).clone(),
                    zero + 1.0, hs0, zero, zero)

        def cond(st, a):
            return _live(st[0], a[2], a[2] - a[1], st[6], self.max_steps)

        def body(st, a):
            kk, t0, t1, x, u = a
            t, X, hh, k, h, nh, nstep = st
            n = X.shape[-1]
            h = torch.minimum(h, t1 - t)
            # node times relative to t_n (X[3])
            tau1 = -hh[2]
            tau2 = tau1 - hh[1]
            # per-order corrector coefficients (all orders, then selected)
            a0s, hists, xps = [], [], []
            for taus in ([h, 0.0], [h, 0.0, tau1], [h, 0.0, tau1, tau2]):
                wd = self._lagrange_dot_weights(taus, h)
                a0s.append(wd[0])
                hist = X.new_zeros(n)
                for j in range(1, len(taus)):
                    hist = hist - wd[j] * X[3 - (j - 1)]
                hists.append(hist)
                wp = self._lagrange_weights(taus[1:], h)
                xp = X.new_zeros(n)
                for j, w in enumerate(wp):
                    xp = xp + w * X[3 - j]
                xps.append(xp)

            def pick(v):
                return torch.where(k == 1, v[0],
                                   torch.where(k == 2, v[1], v[2]))

            a0, hist, xp = pick(a0s), pick(hists), pick(xps)
            xc = self._implicit_step(F, kk, t + h, xp, a0, hist, u)
            err = scaled((xc - xp) / (k + 1.0), X[3], xc)
            accept = err <= 1.0

            # order selection: predictor residuals per order
            e1 = scaled((xc - xps[0]) / 2.0, X[3], xc)
            e2 = scaled((xc - xps[1]) / 3.0, X[3], xc)
            e3 = scaled((xc - xps[2]) / 4.0, X[3], xc)
            r1 = 0.9 * e1 ** (-1.0 / 2.0)
            r2 = torch.where(nh >= 2, 0.9 * e2 ** (-1.0 / 3.0), 0.0)
            r3 = torch.where(nh >= 3, 0.9 * e3 ** (-1.0 / 4.0), 0.0)
            rs = torch.stack([r1, r2, r3][:kmax])
            kbest = torch.argmax(rs).to(k.dtype) + 1.0
            knext = torch.minimum(torch.maximum(kbest, k - 1.0), k + 1.0)
            knext = torch.minimum(torch.maximum(knext, k.new_ones(())),
                                  torch.clamp(nh + 1.0, max=kmax))
            rsel = rs.index_select(0, (knext - 1.0).long().reshape(1))[0]

            fac = torch.where(accept, _clip(rsel, 0.2, 2.5),
                              _clip(0.9 * err ** (-1.0 / (k + 1.0)), 0.1,
                                    0.9))
            Xn = torch.where(accept, torch.cat([X[1:], xc[None]], dim=0), X)
            hhn = torch.where(accept, torch.cat([hh[1:], h[None]]), hh)
            return (torch.where(accept, t + h, t), Xn, hhn,
                    torch.where(accept, knext, k), h * fac,
                    torch.where(accept, torch.clamp(nh + 1.0, max=3.0), nh),
                    nstep + 1)

        def out(st, a):
            return _nan_unless_reached(st[0], a[2], a[2] - a[1], st[1][3])

        return init, cond, body, out

    def solve(self, F, kk, t0, t1, x, u):
        return _run_loop(*self._loop_parts(F), kk, t0, t1, x, u)

    def solve_stats(self, F, kk, t0, t1, x, u):
        """(x(t1), attempted steps, final order) of one unbatched solve,
        outside any transform -- test/diagnostic hook (the reference reads
        DASPK's IWORK counters the same way)."""
        _, st, _ = _Loop(*self._loop_parts(F)).final_state(
            _args(kk, t0, t1, x, u))
        return st[1][0, 3], int(host(st[6][0])), int(host(st[3][0]))
