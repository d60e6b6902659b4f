"""SQP iteration engine and solve loop.

Port of ``hqp_tpu/sqp/solver.py`` (reference: hqp/Hqp_SqpSolver.C and the
Tcl solve loop hqp/hqp_solve.tcl:83-265): qp_update (Lagrangian
gradient, quasi-Newton update), qp_solve (hot/cold started IP
subproblem), step (globalization + the ``feasible_vals`` rescue), the
Hessian restart, and the convergence, error and stall tests that define
when a problem counts as solved.  A StageQP program factors through the
partitioned backend, any other (a DenseQP from an Nlp) through the dense
LU backend.  The scalars each phase needs on the host come back in one
stacked read.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from hqp_tpu_torch.qp import kkt
from hqp_tpu_torch.qp import mehrotra as ip
from hqp_tpu_torch.qp.program import StageQP
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.diagnostics import est_y
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host


class SqpError(RuntimeError):
    """Solve-loop error, reason strings as in hqp/hqp_solve.tcl
    (evaluation, subiters, iters, infeasible, degenerate, stall)."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


def infeasibility(qp):
    """max(||b||_inf, max(0, -min d)) -- hqp/Hqp_SqpSolver.C:155-170."""
    mask = qp.ineq_mask()
    vals = qp.eval_ineq(qp.zero_x())
    viol = torch.clamp(-mk.vmin(vals, mask), min=0.0)
    b = qp.eq_offsets()
    if mk.tsize(b):
        viol = torch.maximum(viol, mk.norm_inf(b, qp.eq_mask()))
    return viol


def _penalty_ineq(qp, r, vals):
    return mk.total(mk.tmap(lambda ri, di: -ri * torch.clamp(di, max=0.0),
                            r, vals), qp.ineq_mask())


def _phi(f, qp, re, r):
    """Powell's exact penalty phi = f + re'|b| - r'min(0, d)
    (hqp/Hqp_SqpPowell.C:189-210)."""
    pen_i = _penalty_ineq(qp, r, qp.eval_ineq(qp.zero_x()))
    b = qp.eq_offsets()
    pen_e = (mk.inner(re, mk.tmap(torch.abs, b), qp.eq_mask())
             if mk.tsize(b) else 0.0)
    return f + pen_e + pen_i


def _phi1(f, qp, s, re, r):
    """Predicted penalty at unit step (hqp/Hqp_SqpPowell.C:213-244)."""
    pen_i = _penalty_ineq(qp, r, qp.eval_ineq(s))
    ret = f + mk.inner(qp.c, s)
    b = qp.eval_eq(s)
    if mk.tsize(b):
        ret = ret + mk.inner(re, mk.tmap(torch.abs, b), qp.eq_mask())
    return ret + pen_i


def _grd_L_of_qp(qp, y, z):
    """c - A'y - C'z from the (possibly stale) QP data
    (hqp/Hqp_SqpSolver.C:430-445)."""
    return qp.c - qp.matvec_eqT(y) - qp.matvec_ineqT(z)


def _update_stats(qp, x, f, f_bak, grd_L):
    """[xQx, norm_inf, |df|, ||grd_L||, ||x||] for one host read."""
    return torch.stack([
        mk.inner(qp.matvec_Q(x), x), infeasibility(qp), (f_bak - f).abs(),
        mk.norm_inf(grd_L, qp.x_mask()), mk.norm_inf(x)])


class SqpSolver:
    """Base SQP solver; subclasses implement ``update_vals`` (line search).

    Defaults follow hqp/Hqp_SqpSolver.C:57-130: eps = 1e-5, QP eps = 1e-9,
    max_iters = 500, min_alpha = 1e-10, max_inf_iters = 10.
    """

    name = "SqpSolverBase"

    def __init__(self, prg, hela=None, qp_solver=None, kkt_backend=None,
                 eps=1e-5, qp_eps=1e-9, max_iters=500, min_alpha=1e-10,
                 max_inf_iters=10, qp_max_iters=50, logging=False):
        from hqp_tpu_torch.sqp.hessian import BFGS

        self.prg = prg
        self.hela = hela if hela is not None else BFGS()
        self.eps = eps
        self.min_alpha = min_alpha
        self.max_iters = max_iters
        self.max_inf_iters = max_inf_iters
        self.logging = logging
        #: a default QP solver takes its tolerance floor from the backend's
        #: factor dtype once init() has resolved the backend
        self._default_qp = qp_solver is None
        if qp_solver is None:
            qp_solver = ip.Mehrotra(eps=qp_eps, max_iters=qp_max_iters)
        self.qp_solver = qp_solver
        self._kkt_backend = kkt_backend  # resolved at init() from QP type

        # iterate state
        self.x = None
        self.f = None
        self.qp = None
        self.ip_state = None
        self.y = None
        self.z = None
        self.d = None          # last accepted step = alpha * s
        self.s = None          # last QP solution
        self.iter = 0
        self.inf_iters = 0
        self.alpha = 1.0
        self.status = ip.ITERATING
        self.qp_iters_last = 0
        self.qp_iters_total = 0
        self.xQx = 0.0
        self.sQs = 0.0
        self.norm_dx = 0.0
        self.norm_x = 0.0
        self.norm_inf = math.inf
        self.norm_grd_L = math.inf
        self.norm_df = 0.0
        self.f_bak = 0.0
        self.grd_L = None
        self._hot_started_sqp = False

    # -- setup ---------------------------------------------------------------

    def init(self):
        """prg_setup + sqp_init."""
        self.x = self.prg.setup()
        f, qp = self.prg.make_qp(self.x)
        self.f, self.qp = f, qp
        if self._kkt_backend is None:
            if isinstance(qp, StageQP):
                from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
                self._kkt_backend = PartitionedKKT()
            else:
                self._kkt_backend = kkt.DenseKKT()
        self.qp_solver = self.qp_solver.with_backend(self._kkt_backend)
        lu = getattr(self._kkt_backend, "_lu", None)
        if self._default_qp and lu is not None and lu() == torch.float32:
            # the QP tolerance cannot be tighter than the f32 factor
            # path's refined KKT floor (~1e-7); per instance, not backend
            self.qp_solver.eps = max(self.qp_solver.eps, 1e-7)
        self.ip_state = self.qp_solver.init_state(qp)
        if getattr(self.hela, "init_multipliers", False):
            # least-squares multipliers before the first Hessian scale
            # estimate (Hqp_HL::est_y)
            self.y = est_y(qp)
        else:
            self.y = mk.fill(qp.eq_offsets(), 0.0)
        self.z = mk.fill(qp.ineq_mask(), 0.0)
        self.iter = 0
        self.inf_iters = 0
        self.alpha = 1.0
        self.status = ip.ITERATING
        self.subclass_init()

    def subclass_init(self):
        pass

    def simulate(self):
        """prg_simulate: initial-value rollout before solving (a program
        without dynamics, an Nlp, has none)."""
        if not hasattr(self.prg, "simulate"):
            return
        self.x = self.prg.simulate(self.x)
        f, qp = self.prg.make_qp(
            self.x, Q=self.qp.Q if self.qp is not None else None)
        self.f, self.qp = f, qp

    # -- qp_update (hqp/Hqp_SqpSolver.C:206-267) ----------------------------

    def qp_update(self):
        prg = self.prg
        if self.iter == 0:
            f, qp = prg.make_qp(self.x)
            Qb = self.hela.init(prg, self.x, self.y, self.z,
                                prg.q_to_blocks(qp.Q))
            qp = dataclasses.replace(qp, Q=prg.q_from_blocks(Qb))
            self.f, self.qp = f, qp
            st = host(_update_stats(qp, self.x, f, f, qp.c))
            self.xQx = st[0]
            self.sQs = self.xQx
            self.norm_inf = st[1]
            self.norm_df = 0.0
            self.norm_grd_L = st[3]
            self.norm_x = st[4]
            self.grd_L = qp.c
        else:
            dL_old = _grd_L_of_qp(self.qp, self.y, self.z)
            f, qp = prg.make_qp(self.x, Q=self.qp.Q)
            self.f, self.qp = f, qp
            grd_L = _grd_L_of_qp(qp, self.y, self.z)
            dL = torch.where(qp.x_mask(), grd_L - dL_old, 0.0)
            if hasattr(self.hela, "bind"):
                # exact-Hessian strategies evaluate at the iterate
                self.hela.bind(prg, self.x, self.y, self.z)
            Qb = self.hela.update(prg.q_to_blocks(qp.Q),
                                  prg.split_blocks(self.d),
                                  prg.split_blocks(dL), self.alpha)
            qp = dataclasses.replace(qp, Q=prg.q_from_blocks(Qb))
            self.qp = qp
            self.grd_L = grd_L
            st = host(_update_stats(qp, self.x, f, self.f_bak, grd_L))
            self.xQx = st[0]
            self.norm_inf = st[1]
            self.norm_df = st[2]
            self.norm_grd_L = st[3]

    # -- qp_solve (hqp/Hqp_SqpSolver.C:270-302) ------------------------------

    def qp_solve(self):
        self.f_bak = self.f
        hot = (self.iter > 0 and self.status == ip.OPTIMAL
               and self.alpha > self.min_alpha)
        self.ip_state = self.qp_solver.solve(self.qp, self.ip_state, hot=hot)
        self.s = self.ip_state.x
        self.y = self.ip_state.y
        self.z = self.ip_state.z
        st = host(torch.stack([
            self.ip_state.result.to(torch.float64),
            self.ip_state.iter.to(torch.float64),
            mk.inner(self.qp.matvec_Q(self.s), self.s),
            mk.norm_inf(self.s)]))
        self.status = int(st[0])
        self.qp_iters_last = int(st[1])
        self.qp_iters_total += self.qp_iters_last
        self.sQs = st[2]
        self.norm_dx = st[3]

    # -- MPC hot start (hqp/Hqp_SqpSolver.C:321-340, hqp_solve.tcl:76-78) ----

    def qp_reinit_bd(self):
        """Re-initialize bounds and values after the problem data changed
        (a shifted initial state in an MPC loop), snapshotting the Hessian
        of the last cold solution at the first call and restoring it at
        every later one.  The snapshot is the QP's own Q tensor: no hela
        writes a Q in place, each update makes a new one."""
        if hasattr(self.prg, "repin"):
            self.x = self.prg.repin(self.x)
        f, qp = self.prg.update_fbd_qp(self.qp, self.x, self.x)
        self.f, self.qp = f, qp
        self.norm_inf = host(infeasibility(qp))
        if not self._hot_started_sqp:
            self._qp_Q_hot = self.qp.Q
            self._hot_started_sqp = True
        else:
            self.qp = dataclasses.replace(self.qp, Q=self._qp_Q_hot)

    def solve_hot(self, max_iters=None):
        """Re-solve after a bound change, reusing the SQP iterate,
        multipliers, Hessian snapshot and the IP's (z, w) hot-start pair
        (hqp_solve_hot, hqp/hqp_solve.tcl:76-78)."""
        self.qp_reinit_bd()
        return self.solve(max_iters=max_iters, hot=True)

    # -- hessian restart (hqp/Hqp_SqpSolver.C:305-318) -----------------------

    def hela_restart(self):
        Q0 = torch.zeros_like(self.prg.q_to_blocks(self.qp.Q))
        Qb = self.hela.init(self.prg, self.x, self.y, self.z, Q0)
        self.qp = dataclasses.replace(self.qp, Q=self.prg.q_from_blocks(Qb))

    # -- rescue for suboptimal QP (hqp/Hqp_SqpSolver.C:343-369) --------------

    def feasible_vals(self):
        old_norm_inf = max(self.norm_inf, self.eps)
        self.y = mk.fill(self.y, 0.0)
        self.z = mk.fill(self.z, 0.0)
        x0 = self.x
        alpha = 1.0
        while True:
            xk = x0 + alpha * self.s
            f, qp = self.prg.update_fbd_qp(self.qp, x0, xk)
            self.x, self.f, self.qp = xk, f, qp
            fv, ninf = host(torch.stack([f, infeasibility(qp)]))
            self.norm_inf = ninf
            if math.isfinite(fv) and ninf < 1e2 * old_norm_inf:
                break
            alpha *= 0.5
            if alpha <= self.min_alpha:
                break
        self.alpha = alpha
        self.d = alpha * self.s

    # -- step (hqp/Hqp_SqpSolver.C:372-405) ----------------------------------

    def step(self):
        if self.status == ip.SUBOPTIMAL:
            self.feasible_vals()
        else:
            self.update_vals()
            if self.alpha <= self.min_alpha:
                self.feasible_vals()
        self.norm_x, self.norm_inf, self._fv = host(torch.stack(
            [mk.norm_inf(self.x), infeasibility(self.qp), self.f]))
        self.iter += 1
        if self.status not in (ip.OPTIMAL, ip.FEASIBLE):
            self.inf_iters += 1
        else:
            self.inf_iters = 0

    def update_vals(self):
        raise NotImplementedError

    # -- solve loop (hqp/hqp_solve.tcl:83-265) -------------------------------

    def solve(self, max_iters=None, hot=False):
        if max_iters is not None:
            self.max_iters = max_iters
        if self.x is None:
            self.init()
        eps = self.eps
        nullsteps = 0
        skip_update = hot  # a hot start cannot reuse higher-order info
        while True:
            if skip_update:
                skip_update = False
            else:
                self.qp_update()
            fv = host(self.f)
            if not (math.isfinite(fv) and math.isfinite(self.norm_inf)):
                raise SqpError("evaluation")
            if self.logging:
                self._log_row(fv)
            hela_restart = False
            if self.xQx < 0.0:
                self.hela_restart()
                hela_restart = True
            if self.iter > 0 and self.norm_inf < eps \
                    and self.norm_grd_L < eps:
                break
            self.qp_solve()
            if self.qp_iters_last == 0 and self.status != ip.OPTIMAL:
                raise SqpError(ip.RESULT_STRINGS[self.status])
            if self.sQs < 0.0:
                self.hela_restart()
                hela_restart = True
            if self.iter > 0 and self.sQs >= 0.0 and not hela_restart:
                if self.norm_inf < eps and self.status == ip.OPTIMAL:
                    if self.sQs < eps * eps:
                        break
                    if self.iter > 2 and \
                            self.norm_dx < eps * self.norm_x and \
                            self.norm_df < eps * abs(fv) and \
                            self.sQs < eps:
                        break
            self.step()
            if self.qp_iters_last >= self.qp_solver.max_iters \
                    and self.status != ip.FEASIBLE:
                raise SqpError("subiters")
            if self.iter >= self.max_iters:
                raise SqpError("iters")
            if self.inf_iters >= self.max_inf_iters:
                if self.status == ip.SUBOPTIMAL:
                    raise SqpError("infeasible")
                raise SqpError("degenerate")
            if self.alpha < 1e-8 and self.norm_df < eps * abs(self._fv):
                nullsteps += 1
            else:
                nullsteps = 0
            if nullsteps > 5:
                raise SqpError("stall")
        return "optimal"

    def _log_row(self, fv):
        print(f"{self.iter:3d} {fv:12.6g} "
              f"{self.norm_inf:10.4g} {self.norm_grd_L:10.4g} "
              f"[{self.qp_iters_last:3d}] {self.norm_dx:10.4g} "
              f"{self.sQs:10.4g} {self.alpha:8.3g}", flush=True)


def solve(prg, solver="Powell", **kw):
    """Build the named SQP solver for a program and run it (the odc script
    flow prg_setup; prg_simulate; sqp_init; hqp_solve, odc/run:26-79)."""
    import hqp_tpu_torch.sqp.powell  # noqa: F401  (registers "Powell")

    s = modules.create("sqp_solver", solver, prg, **kw)
    s.init()
    s.simulate()
    result = s.solve()
    return s, result
