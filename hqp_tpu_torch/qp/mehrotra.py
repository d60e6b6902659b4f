"""Mehrotra predictor-corrector interior-point QP solver.

Port of ``hqp_tpu/qp/mehrotra.py`` (reference:
hqp/Hqp_IpsMehrotra.C): cold start with unit (z, w) and Mehrotra's
initial-point shift, the relative KKT test, the infeasibility / slow
progress / blow-up aborts, the affine predictor with Mehrotra's cubic
centering, the adaptive step length, and hot starts from snapshotted
(z, w) with fallback to a cold start.

The reference runs the iteration as one ``lax.while_loop`` on the device.
Here the loop runs on the host; each IP iteration reads back one flag
vector to take the step branch and one to test the loop
(:func:`~hqp_tpu_torch.utils.sync.host`), besides the refinement tests of
the KKT backend.  The state scalars stay tensors, as in the reference.

A program structurally without inequality rows takes the reference's
equality-only branch: one Newton step per QP.  (A ``StageQP`` always
carries its [K+1, nv] box groups, so its masked-off rows run the general
iteration, in both packages.)

A batch of StageQPs (leading batch axes, :mod:`hqp_tpu_torch.parallel.
scenarios`) runs as ``jax.vmap`` runs the reference's
:meth:`solve_device`: the state scalars get the batch shape, one host loop
steps every problem in lockstep while any is live, and each problem is
frozen at its own result and iteration count, as if solved alone.  The
step branch becomes a per-problem select.  Hot starts and the
equality-only branch stay unbatched (a batch raises
``NotImplementedError``).

The reference's non-default knobs are ported, on one QP and on a batch:
``init_method`` 1-3 (the cold start's w from the norms of Q, C and d, the
-z w complementarity right-hand side, and method 3's dz/dw shift),
``mod_terlaky`` (Terlaky's sigma, clamped at 1, and the pure-centering
redo when the corrector is blocked: a host branch on one QP, a
per-problem select on a batch), ``gondzio_correctors`` (that many
centrality correction solves with the same factorization, each taken per
problem only where it lengthens the step, with no host read) and
``cheap_predictor`` (the affine predictor by ``backend.with_refine(0)``
where the backend has it, as ``PartitionedKKT`` does).

Spans (:mod:`hqp_tpu_torch.utils.log`): ``mehrotra.solve`` (a whole solve),
``mehrotra.cold_start``, and ``mehrotra.step`` with its phases
``mehrotra.residuals`` (up to the step branch's read),
``mehrotra.predictor`` (factorization and affine solve),
``mehrotra.corrector`` (centering and corrector solves) and
``mehrotra.step_length`` (step length and update).
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from hqp_tpu_torch.utils import log
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host

# result codes, aligned with hqp/Hqp_impl.h:37-46
OPTIMAL = 0
FEASIBLE = 1
INFEASIBLE = 2
SUBOPTIMAL = 3
DEGENERATE = 4
ITERATING = 5

RESULT_STRINGS = {
    OPTIMAL: "optimal",
    FEASIBLE: "feasible",
    INFEASIBLE: "infeasible",
    SUBOPTIMAL: "suboptimal",
    DEGENERATE: "degenerate",
    ITERATING: "iterating",
}


@dataclasses.dataclass
class IPState:
    """Full interior-point iterate (tensors on the QP's device)."""

    x: torch.Tensor
    y: dict
    z: object        # IneqGroups
    w: object
    z_hot: object
    w_hot: object
    iter: torch.Tensor       # int64
    result: torch.Tensor     # int64 code
    gap: torch.Tensor
    test: torch.Tensor       # phi of the last step
    alpha: torch.Tensor
    mu0: torch.Tensor
    norm_r0: torch.Tensor
    phimin: torch.Tensor     # [max_iters + 1]
    # (a batch: every scalar of the batch shape, phimin [*batch, max+1])


class Mehrotra:
    """Mehrotra predictor-corrector IP solver over an exchangeable backend.

    Defaults as in the reference package: Mehrotra's cubic centering (not
    the Terlaky modification), no Gondzio correctors, the plain cold
    start and a refined predictor."""

    def __init__(self, backend=None, eps=1e-9, max_iters=50, max_warm_iters=25,
                 gammaf=0.01, init_method=0, mod_terlaky=False,
                 gondzio_correctors=0, cheap_predictor=False):
        self.backend = backend
        self.eps = eps
        self.max_iters = max_iters
        self.max_warm_iters = max_warm_iters
        self.gammaf = gammaf
        self.init_method = init_method
        self.mod_terlaky = mod_terlaky
        self.gondzio_correctors = gondzio_correctors
        #: solve the affine predictor without the true-residual refinement
        #: (backend.with_refine(0)); the corrector keeps the full gate
        self.cheap_predictor = cheap_predictor

    def with_backend(self, backend):
        """A solver with ``backend`` bound (a copy if it differs)."""
        if backend is self.backend:
            return self
        new = copy.copy(self)
        new.backend = backend
        return new

    # -- state construction --------------------------------------------------

    @staticmethod
    def _lead(qp):
        """The batch shape of ``qp`` (() for one problem)."""
        return qp.c.shape[:qp.nb]

    def _scalars(self, qp):
        """Fresh loop scalars: iteration 0, ITERATING, phi = inf, alpha 1."""
        dev, lead = qp.device, self._lead(qp)
        f = dict(dtype=torch.float64, device=dev)
        return dict(iter=torch.zeros(lead, dtype=torch.int64, device=dev),
                    result=torch.full(lead, ITERATING, dtype=torch.int64,
                                      device=dev),
                    test=torch.full(lead, float("inf"), **f),
                    alpha=torch.ones(lead, **f),
                    phimin=torch.zeros(lead + (self.max_iters + 1,), **f))

    def init_state(self, qp):
        mask = qp.ineq_mask()
        ones = mk.fill(mask, 1.0)
        f = dict(dtype=torch.float64, device=qp.device)
        lead = self._lead(qp)
        return IPState(
            x=qp.zero_x(), y=mk.fill(qp.eq_offsets(), 0.0),
            z=ones, w=ones, z_hot=ones, w_hot=ones,
            gap=torch.zeros(lead, **f), mu0=torch.ones(lead, **f),
            norm_r0=torch.ones(lead, **f), **self._scalars(qp))

    @staticmethod
    def _no_ineq(qp):
        """Structurally no inequality rows (reference's m == 0 case)."""
        return mk.tsize(qp.ineq_mask()) == 0

    @staticmethod
    def _unbatched(qp, what):
        if qp.nb:
            raise NotImplementedError(
                f"Mehrotra: {what} of a batch of QPs is not ported (the "
                "batch path is the cold-started solve_device)")

    # -- cold start (Hqp_IpsMehrotra.C:209-327) ------------------------------

    @log.spanned("mehrotra.cold_start")
    def cold_start(self, qp, state: IPState):
        nb = qp.nb
        if self._no_ineq(qp):
            self._unbatched(qp, "the equality-only branch")
            # program without inequality constraints (C:322-327)
            return dataclasses.replace(
                state, x=qp.zero_x(), y=mk.fill(qp.eq_offsets(), 0.0),
                **self._scalars(qp))
        mask = qp.ineq_mask()
        m = torch.clamp(mk.count(mask, nb), min=1.0)
        ones = mk.where(mask, mk.fill(mask, 1.0), 1.0)
        z = w = ones
        if self.init_method in (1, 2):
            nQ, nC, nd = _norm_Q(qp), _norm_C(qp), _norm_d(qp)
            val = nd * nQ / nC if self.init_method == 1 else nC / nd / nQ
            w = mk.where(mask, mk.scale(val, ones), 1.0)

        r1 = torch.where(qp.x_mask(), qp.c, 0.0)
        r2 = mk.scale(-1.0, qp.eq_offsets())
        r3 = mk.where(mask, mk.scale(-1.0, qp.ineq_offsets()), 0.0)
        if self.init_method:
            r4 = mk.where(mask, mk.tmap(lambda a, b: -a * b, z, w), 0.0)
        else:
            r4 = mk.fill(mask, 0.0)

        fac = self.backend.factor(qp, z, w, mask)
        dx, dy, dz, dw = self.backend.solve(fac, qp, z, w, mask,
                                            r1, r2, r3, r4)
        if self.init_method == 3:
            dz, dw = mk.add(dz, z), mk.add(dw, w)

        # Mehrotra's initial point shift (C:299-315)
        dz = _unzero(dz, mask, nb)
        dw = _unzero(dw, mask, nb)
        delz = torch.clamp(-1.5 * mk.vmin(dz, mask, nb), min=0.0)
        delw = torch.clamp(-1.5 * mk.vmin(dw, mask, nb), min=0.0)
        d1 = mk.tmap(lambda a: a + mk.bc(delz, a), dz)
        d2 = mk.tmap(lambda a: a + mk.bc(delw, a), dw)
        gap = mk.inner(d1, d2, mask, nb)
        den_z = mk.total(dw, mask, nb) + m * delw
        delz = delz + torch.where(den_z != 0.0, 0.5 * gap / den_z, 0.0)
        den_w = mk.total(dz, mask, nb) + m * delz
        delw = delw + torch.where(den_w != 0.0, 0.5 * gap / den_w, 0.0)
        z = mk.where(mask, mk.tmap(lambda a: a + mk.bc(delz, a), dz), 1.0)
        w = mk.where(mask, mk.tmap(lambda a: a + mk.bc(delw, a), dw), 1.0)

        degen = ~(torch.isfinite(mk.norm_inf(dx, nb=nb))
                  & torch.isfinite(gap))
        sc = self._scalars(qp)
        sc["result"] = torch.where(degen, DEGENERATE, sc["result"])
        return IPState(
            x=dx, y=dy, z=z, w=w, z_hot=ones, w_hot=ones, gap=gap,
            mu0=torch.ones_like(gap), norm_r0=torch.ones_like(gap), **sc)

    def hot_start(self, qp, state: IPState):
        """Re-use the snapshotted (z, w); Hqp_IpsMehrotra.C:330-352."""
        self._unbatched(qp, "a hot start")
        return dataclasses.replace(state, z=state.z_hot, w=state.w_hot,
                                   **self._scalars(qp))

    # -- one predictor-corrector step (Hqp_IpsMehrotra.C:355-693) ------------

    @log.spanned("mehrotra.step")
    def step(self, qp, state: IPState) -> IPState:
        """One step; for a batch, of every problem, each taking its own
        branch (the factorization is skipped when none takes a step).
        Its spans: the residuals and tests up to the step branch's read,
        the factorization and affine predictor, the centering and
        corrector solve(s), and the step length and update."""
        if self._no_ineq(qp):
            self._unbatched(qp, "the equality-only branch")
            return self._step_eq_only(qp, state)
        with log.timers.span("mehrotra.residuals"):
            eps = self.eps
            nb = qp.nb
            mask = qp.ineq_mask()
            m = torch.clamp(mk.count(mask, nb), min=1.0)
            x, y, z, w = state.x, state.y, state.z, state.w

            # residuals of the KKT conditions (C:425-445)
            Qx = qp.matvec_Q(x)
            gap = (mk.inner(x, Qx + qp.c, nb=nb)
                   + mk.inner(y, qp.eq_offsets(), qp.eq_mask(), nb)
                   + mk.inner(z, qp.ineq_offsets(), mask, nb))
            r1 = torch.where(
                qp.x_mask(),
                Qx + qp.c - qp.matvec_eqT(y) - qp.matvec_ineqT(
                    mk.where(mask, z, 0.0)), 0.0)
            r2 = mk.scale(-1.0, qp.eval_eq(x))
            r3 = mk.where(mask, mk.sub(w, qp.eval_ineq(x)), 0.0)
            r4 = mk.where(mask, mk.tmap(lambda a, b: -a * b, z, w), 0.0)
            mu = mk.inner(z, w, mask, nb) / m

            norm_r = torch.maximum(
                torch.maximum(mk.norm_inf(r1, nb=nb),
                              mk.norm_inf(r2, qp.eq_mask(), nb)),
                mk.norm_inf(r3, mask, nb))
            norm_data = qp.norm_data()

            first = state.iter == 0
            mu0 = torch.where(first, mu, state.mu0)
            norm_r0 = torch.where(first, norm_r, state.norm_r0)

            phi = (norm_r + gap.abs()) / norm_data
            if nb:
                phimin = state.phimin.scatter(-1, state.iter[..., None],
                                              phi[..., None])
            else:
                phimin = state.phimin.index_put((state.iter.reshape(1),),
                                                phi.reshape(1))

            # hot start snapshot while still far from the central path
            # (C:475-478)
            snap = phi > eps ** 0.3333
            z_hot = mk.sel(snap, z, state.z_hot)
            w_hot = mk.sel(snap, w, state.w_hot)

            # termination / abort tests (C:482-519)
            iters = torch.arange(self.max_iters + 1, device=phi.device)
            it = state.iter[..., None]
            seen = iters <= it
            pm = torch.where(seen, phimin, float("inf")).amin(-1)
            # never optimal at entry (iter 0): a cold start enters with zero
            # (x, y), a hot start with the previous solution
            optimal = (mu <= eps) & (norm_r <= eps * norm_data) \
                & (state.iter > 0)
            subopt = (phi > eps) & (phi >= 1.0e4 * pm)
            seen30 = (iters >= 1) & (iters <= it - 30)
            pm30 = torch.where(seen30, phimin, float("inf")).amin(-1)
            slow = (state.iter >= 30) & (pm >= 0.5 * pm30)
            blowup = (norm_r > eps * norm_data) & \
                (norm_r / mu >= 1.0e8 * norm_r0 / mu0)

            # the blow-up test sets Suboptimal but does NOT skip the step
            # (C:513-519); the solve loop exits after this final step
            result = torch.where(
                optimal, OPTIMAL,
                torch.where(subopt | slow | blowup, SUBOPTIMAL, ITERATING))
            take_step = (~optimal) & (~subopt) & (~slow)

            base = dataclasses.replace(
                state, z_hot=z_hot, w_hot=w_hot, gap=gap, test=phi, mu0=mu0,
                norm_r0=norm_r0, phimin=phimin, result=result)
            go = host(take_step.any() if nb else take_step)
        if not go:
            return base

        with log.timers.span("mehrotra.predictor"):
            # factorization + affine predictor (C:524-562)
            fac = self.backend.factor(qp, z, w, mask)
            pred_be = self.backend.with_refine(0) \
                if self.cheap_predictor and \
                hasattr(self.backend, "with_refine") else self.backend
            dxa, dya, dza, dwa = pred_be.solve(
                fac, qp, z, w, mask, r1, r2, r3, r4)
            alpha_aff = torch.clamp(
                torch.minimum(mk.ratio_min(z, dza, mask, nb),
                              mk.ratio_min(w, dwa, mask, nb)), 0.0, 1.0)

        with log.timers.span("mehrotra.corrector"):
            def corrector(sig):
                smm = sig * mu
                r4c = mk.where(
                    mask,
                    mk.tmap(lambda zi, wi, a, b:
                            -(zi * wi + a * b - mk.bc(smm, zi)),
                            z, w, dza, dwa), 0.0)
                return self.backend.solve(fac, qp, z, w, mask,
                                          r1, r2, r3, r4c)

            if self.mod_terlaky:
                # Terlaky centering (C:584-591), sigma clamped at 1 as the
                # reference clamps it (the SIGMA_CAP rows can inflate t)
                gamma = 1.0e-4 ** 0.25
                t = mk.vmax(mk.tmap(
                    lambda a, b, zi, wi: torch.where(a * b > 0.0,
                                                     a * b / zi / wi, 0.0),
                    dza, dwa, z, w), mask, nb)
                t = torch.clamp(t, min=0.0)
                sigma = torch.clamp(gamma * (t + 1.0 - alpha_aff)
                                    / (1.0 - gamma), max=1.0)
                dirs = corrector(sigma)
                alpha_corr = torch.clamp(
                    torch.minimum(mk.ratio_min(z, dirs[2], mask, nb),
                                  mk.ratio_min(w, dirs[3], mask, nb)),
                    0.0, 1.0)
                # pure centering when the corrector is blocked (C:604-623):
                # the reference's branch, per problem on a batch
                redo = (alpha_aff < 0.1) | \
                    (alpha_corr < gamma * gamma / 2.0 / m / m)
                if host(redo.any() if nb else redo):
                    dirs = mk.sel(redo, corrector(gamma / (1.0 - gamma)),
                                  dirs)
                dx, dy, dz, dw = dirs
            else:
                # Mehrotra's original centering (C:578-583)
                zp = mk.where(mask, mk.axpy(alpha_aff, dza, z), 0.0)
                wp = mk.where(mask, mk.axpy(alpha_aff, dwa, w), 0.0)
                mu_aff = mk.inner(zp, wp, mask, nb) / m
                sigma = (mu_aff / mu) ** 3.0
                dx, dy, dz, dw = corrector(sigma)

        with log.timers.span("mehrotra.step_length"):
            # Mehrotra's adaptive step size (C:625-669)
            alpha = self._adaptive_alpha(z, w, dz, dw, mask, m, nb)

            # Gondzio's centrality correctors (beyond the reference; Gondzio
            # 1996): push the trial products into [0.1, 10] sigma mu by
            # correction solves with the same factorization, each taken per
            # problem only where it lengthens the step
            mu_t = torch.clamp(sigma * mu, min=1e-30)
            for _ in range(self.gondzio_correctors):
                abar = torch.clamp(2.0 * alpha + 0.1, max=1.0)
                zt = mk.where(mask, mk.axpy(abar, dz, z), 1.0)
                wt = mk.where(mask, mk.axpy(abar, dw, w), 1.0)
                pr = mk.tmap(lambda a, b: a * b, zt, wt)
                tgt = mk.tmap(lambda p: torch.clamp(p, 0.1 * mk.bc(mu_t, p),
                                                    10.0 * mk.bc(mu_t, p)), pr)
                r4g = mk.where(mask, mk.sub(tgt, pr), 0.0)
                cx, cy, cz, cw = self.backend.solve(
                    fac, qp, z, w, mask, torch.zeros_like(r1),
                    mk.fill(r2, 0.0), mk.fill(r3, 0.0), r4g)
                nd = (dx + cx, mk.add(dy, cy), mk.add(dz, cz), mk.add(dw, cw))
                na = self._adaptive_alpha(z, w, nd[2], nd[3], mask, m, nb)
                take = na > alpha
                dx, dy, dz, dw = mk.sel(take, nd, (dx, dy, dz, dw))
                alpha = torch.where(take, na, alpha)

            x_n = x + mk.bc(alpha, x) * dx
            y_n = mk.axpy(alpha, dy, y)
            z_n = mk.where(mask, mk.axpy(alpha, dz, z), 1.0)
            w_n = mk.where(mask, mk.axpy(alpha, dw, w), 1.0)

            mu_n = mk.inner(z_n, w_n, mask, nb) / m
            bad = ~(torch.isfinite(mu_n)
                    & torch.isfinite(mk.norm_inf(dx, nb=nb)))

            stepped = dataclasses.replace(
                base, x=mk.sel(bad, x, x_n), y=mk.sel(bad, y, y_n),
                z=mk.sel(bad, z, z_n), w=mk.sel(bad, w, w_n), alpha=alpha,
                iter=base.iter + (~bad).to(torch.int64),
                result=torch.where(bad, DEGENERATE, base.result))
            # a batch: the reference's lax.cond on take_step, per problem
            return mk.sel(take_step, stepped, base) if nb else stepped

    def _step_eq_only(self, qp, state: IPState) -> IPState:
        """Newton step for a program without inequality constraints
        (Hqp_IpsMehrotra.C:364-415): one factor+solve, then optimal."""
        mask = qp.ineq_mask()
        x, y = state.x, state.y
        r1 = torch.where(qp.x_mask(),
                         qp.matvec_Q(x) + qp.c - qp.matvec_eqT(y), 0.0)
        r2 = mk.scale(-1.0, qp.eval_eq(x))
        r3 = mk.fill(mask, 0.0)
        r4 = mk.fill(mask, 0.0)
        z = w = mk.fill(mask, 1.0)
        fac = self.backend.factor(qp, z, w, mask)
        dx, dy, _, _ = self.backend.solve(fac, qp, z, w, mask,
                                          r1, r2, r3, r4)
        bad = ~(torch.isfinite(mk.norm_inf(dx))
                & torch.isfinite(mk.norm_inf(dy)))
        return dataclasses.replace(
            state, x=torch.where(bad, x, x + dx),
            y=mk.tmap(lambda a, b: torch.where(bad, a, a + b), y, dy),
            iter=state.iter + (~bad).to(torch.int64),
            result=torch.where(bad, DEGENERATE, OPTIMAL),
            test=mk.norm_inf(r1) + mk.norm_inf(r2, qp.eq_mask()))

    def _adaptive_alpha(self, z, w, dz, dw, mask, m, nb=0):
        """Mehrotra's adaptive stepsize heuristic (C:625-669); the groups
        are flattened in field order, as ravel_pytree does (per problem
        of a batch)."""
        gammaf = self.gammaf
        zf, wf, dzf, dwf = (mk.flat(t, nb) for t in (z, w, dz, dw))
        mf = mk.flat(mask, nb)

        okz = mf & (dzf < 0.0)
        ratz = torch.where(okz, -zf / torch.where(okz, dzf, -1.0), mk.BIG)
        okw = mf & (dwf < 0.0)
        ratw = torch.where(okw, -wf / torch.where(okw, dwf, -1.0), mk.BIG)
        # first minimum, one per problem
        izmin = torch.argmin(ratz, dim=-1, keepdim=True)
        iwmin = torch.argmin(ratw, dim=-1, keepdim=True)
        zmin = ratz.gather(-1, izmin)[..., 0]
        wmin = ratw.gather(-1, iwmin)[..., 0]

        none_blocking = (zmin >= mk.BIG) & (wmin >= mk.BIG)
        alpha = torch.clamp(torch.minimum(zmin, wmin), max=1.0)

        a = mk.bc(alpha, zf)
        mu_pl = mk.total((zf + a * dzf) * (wf + a * dwf), mf, nb) / m

        w_blocks = wmin <= zmin
        ib = torch.where(mk.bc(w_blocks, iwmin), iwmin, izmin)

        def at(v):
            return v.gather(-1, ib)[..., 0]

        # at the blocking index the "other" variable's positivity decides
        a_other = torch.where(w_blocks, at(zf) + alpha * at(dzf),
                              at(wf) + alpha * at(dwf))
        d_block = torch.where(w_blocks, alpha * at(dwf), alpha * at(dzf))
        v_block = torch.where(w_blocks, at(wf), at(zf))
        fpd = torch.where(a_other > 0.0,
                          (gammaf * mu_pl / a_other - v_block) / d_block, 0.0)
        alpha = torch.clamp(torch.clamp(fpd, min=1.0 - gammaf) * alpha,
                            0.0, 1.0)
        return torch.where(none_blocking, 1.0, alpha)

    # -- full solve with hot-start fallback (C:696-733) ----------------------

    def _solve_loop(self, qp, state: IPState, hot: bool, iter_cap: int):
        """IP steps until the result leaves ITERATING, the iteration cap,
        or (hot starts) the failure test: phi must decay at least like
        1.2^-k and alpha stay above 1e-5 (C:707-719).  One host read per
        iteration tests the loop.  Returns (state, hot_failed, result
        code, iterations) with the last three as read on the host."""
        st = state
        test1 = torch.full((), float("inf"), dtype=torch.float64,
                           device=qp.device)
        fail = torch.zeros((), dtype=torch.bool, device=qp.device)
        while True:
            res, it, failed = host(torch.stack(
                [st.result, st.iter, fail.to(torch.int64)]))
            if res != ITERATING or it >= iter_cap or failed:
                return st, bool(failed), res, it
            st = self.step(qp, st)
            if hot:
                itf = st.iter.to(torch.float64)
                test1 = torch.where(st.iter == 1, st.test, test1)
                failn = (st.iter >= 2) & (
                    (st.test > test1 / 1.2 ** (itf - 1.0))
                    | (st.alpha < 1.0e-5))
                fail = fail | failn

    def _solve_loop_batch(self, qp, st: IPState, iter_cap: int):
        """The loop of a batch, as ``jax.vmap`` of the reference's
        ``while_loop`` runs it: while any problem is live (ITERATING and
        below ``iter_cap``) every problem steps, and the others keep their
        state.  One host read per iteration tests the loop."""
        while True:
            live = (st.result == ITERATING) & (st.iter < iter_cap)
            if not host(live.any()):
                return st
            st = mk.sel(live, self.step(qp, st), st)

    @log.spanned("mehrotra.solve")
    def solve_device(self, qp, state: IPState) -> IPState:
        """Cold start plus the loop to termination (the reference's
        ``solve_device``): the whole solve of one QP or, with leading
        batch axes, of every QP of a batch, each frozen at its own
        result."""
        st = self.cold_start(qp, state)
        if qp.nb:
            return self._solve_loop_batch(qp, st, self.max_iters)
        return self._solve_loop(qp, st, False, self.max_iters)[0]

    def solve(self, qp, state: IPState, hot: bool = False):
        """Full solve with hot-start failure fallback (C:696-733); a batch
        of QPs takes :meth:`solve_device` and refuses a hot start."""
        if qp.nb:
            if hot:
                self._unbatched(qp, "a hot start")
            return self.solve_device(qp, state)
        with log.timers.span("mehrotra.solve"):
            if hasattr(self.backend, "prepare"):
                # the host-sparse backends copy the loop-invariant Q, C and A
                # to the host once per solve (hqp_tpu/qp/mehrotra.py:582-587)
                self.backend.prepare(qp)
            fail_iters = 0
            if hot:
                st = self.hot_start(qp, state)
                st, failed, res, it = self._solve_loop(
                    qp, st, True, min(self.max_warm_iters, self.max_iters))
                if failed or res != OPTIMAL:
                    fail_iters = it
                    st = self.cold_start(qp, st)
                    st = self._solve_loop(
                        qp, st, False, max(self.max_iters - fail_iters, 1))[0]
            else:
                st = self.cold_start(qp, state)
                st = self._solve_loop(qp, st, False, self.max_iters)[0]
            return dataclasses.replace(st, iter=st.iter + fail_iters)


modules.register("sqp_qp_solver", "Mehrotra")(Mehrotra)


def _unzero(t, mask, nb=0):
    """If a direction is identically zero, nudge it (C:299-302)."""
    n = mk.norm_inf(t, mask, nb)
    return mk.tmap(lambda a: torch.where(mk.bc(n == 0.0, a), 1.0e-10, a), t)


def _norm_Q(qp):
    return torch.clamp(mk.amax_all(qp.Q.abs(), qp.nb), min=1e-10)


def _norm_C(qp):
    return torch.clamp(mk.amax_all(qp.C.abs(), qp.nb), min=1e-10)


def _norm_d(qp):
    return torch.clamp(mk.norm_inf(qp.ineq_offsets(), qp.ineq_mask(), qp.nb),
                       min=1e-10)
