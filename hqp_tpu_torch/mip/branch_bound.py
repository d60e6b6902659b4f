"""Branch-and-bound mixed-integer QP solver.

Port of ``hqp_tpu/mip/branch_bound.py``: the role of the reference's MIP
layer (hqp/Hqp_MipSolver.{h,C} module slot + hqp/Hqp_LPSolve.{h,C}, the
lp_solve 5.5 branch&bound driven over the final LP relaxation after SQP,
hqp/hqp_solve.tcl:258-262).  The relaxations keep the QUADRATIC objective
and are solved by the port's Mehrotra interior point over ``DenseKKT`` on
the QP's device.

Branching never changes the QP's shapes: the integer bounds live in two
dedicated inequality-row blocks appended to the QP (x_i - lb_i >= 0 and
ub_i - x_i >= 0 for every integer variable), and a node only rewrites
their offsets ``d`` and row masks.  Best-first search on (f, counter)
with incumbent pruning runs on the host, branching on the most
fractional integer variable, as in the reference package; each node
reads its result, objective, feasibility and integer values back in one
counted host read.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np
import torch

from hqp_tpu_torch.qp.mehrotra import Mehrotra, RESULT_STRINGS, OPTIMAL, \
    SUBOPTIMAL
from hqp_tpu_torch.qp.program import DenseQP
from hqp_tpu_torch.utils.registry import modules
from hqp_tpu_torch.utils.sync import host, to_host


@modules.register("mip_solver", "LPSolve")
@modules.register("mip_solver", "BranchBound")
class BranchBound:
    """Best-first branch & bound over interior-point QP relaxations."""

    def __init__(self, qp_solver=None, eps_int: float = 1e-5,
                 max_nodes: int = 1000, gap_tol: float = 1e-9,
                 logging: bool = False):
        if qp_solver is None:
            from hqp_tpu_torch.qp.kkt import DenseKKT
            qp_solver = Mehrotra(backend=DenseKKT())
        self.qp_solver = qp_solver
        self.eps_int = eps_int
        self.max_nodes = max_nodes
        self.gap_tol = gap_tol
        self.logging = logging
        #: statistics of the last solve
        self.nodes = 0
        self.status = "iterating"

    # -- QP augmentation -------------------------------------------------------

    @staticmethod
    def _augment(qp: DenseQP, int_idx):
        """Append the 2*n_int bound rows whose offsets branching rewrites."""
        ni = len(int_idx)
        E = torch.zeros((ni, qp.n), dtype=qp.C.dtype, device=qp.device)
        E[torch.arange(ni), torch.as_tensor(int_idx)] = 1.0
        C = torch.cat([qp.C, E, -E])
        d = torch.cat([qp.d, qp.d.new_zeros(2 * ni)])
        mask = torch.cat([qp.ineq_mask_, qp.ineq_mask_.new_zeros(2 * ni)])
        return dataclasses.replace(qp, C=C, d=d, ineq_mask_=mask)

    @staticmethod
    def _node_qp(aug: DenseQP, mi0, lb, ub):
        """Write node bounds into the dedicated rows: x_i - lb >= 0,
        ub - x_i >= 0; rows with infinite bounds stay masked out."""
        d = np.concatenate([np.where(np.isfinite(lb), -lb, 0.0),
                            np.where(np.isfinite(ub), ub, 0.0)])
        m = np.concatenate([np.isfinite(lb), np.isfinite(ub)])
        dev = aug.device
        return dataclasses.replace(
            aug, d=torch.cat([aug.d[:mi0], torch.as_tensor(
                d, dtype=aug.d.dtype, device=dev)]),
            ineq_mask_=torch.cat([aug.ineq_mask_[:mi0],
                                  torch.as_tensor(m, device=dev)]))

    # -- driver -----------------------------------------------------------------

    def solve(self, qp: DenseQP, int_mask):
        """Minimize the mixed-integer QP.  int_mask: [n] bool of integer
        variables (the reference's Hqp_Program x_int marks,
        hqp/Hqp_Program.h:47).  Returns (x, f, status_string), x a tensor
        on the QP's device or None."""
        int_idx = np.flatnonzero(np.asarray(int_mask))
        if int_idx.size == 0:
            st = self._relax(qp)
            res, f = host(torch.stack([st.result.to(qp.c.dtype),
                                       self._obj(qp, st.x)]))
            self.status = RESULT_STRINGS[int(res)]
            return st.x, f, self.status

        aug = self._augment(qp, int_idx)
        mi0 = qp.mi
        ni = int_idx.size
        idx = torch.as_tensor(int_idx, device=qp.device)

        best_x, best_f = None, np.inf
        self.nodes = 0
        counter = itertools.count()
        heap = [(-np.inf, next(counter), np.full(ni, -np.inf),
                 np.full(ni, np.inf))]

        while heap and self.nodes < self.max_nodes:
            bound, _, lb, ub = heapq.heappop(heap)
            if bound >= best_f - self.gap_tol:
                continue  # pruned by incumbent
            self.nodes += 1
            nqp = self._node_qp(aug, mi0, lb, ub)
            st = self._relax(nqp)
            res, f, eq_viol, ineq_min, *xi = host(torch.cat([
                torch.stack([st.result.to(st.x.dtype), self._obj(nqp, st.x),
                             *self._violations(nqp, st.x)]), st.x[idx]]))
            if int(res) not in (OPTIMAL, SUBOPTIMAL):
                continue  # infeasible / degenerate node
            if eq_viol > 1e-6 or ineq_min < -1e-6:
                # the IP's suboptimal fallback can return an infeasible
                # point for an infeasible node (Hqp_Suboptimal role,
                # hqp/Hqp_SqpSolver.C:343); such a node is fathomed
                continue
            if f >= best_f - self.gap_tol:
                continue
            xi = np.asarray(xi)
            frac = np.abs(xi - np.round(xi))
            j = int(np.argmax(frac))
            if frac[j] <= self.eps_int:
                # integral: new incumbent (round exactly)
                x = to_host(st.x).copy()
                x[int_idx] = np.round(xi)
                best_x, best_f = x, f
                if self.logging:
                    print(f"mip: node {self.nodes} incumbent f={f:.6g}")
                continue
            # branch on the most fractional variable
            lo, hi = lb.copy(), ub.copy()
            hi[j] = np.floor(xi[j])
            heapq.heappush(heap, (f, next(counter), lb.copy(), hi))
            lo[j] = np.ceil(xi[j])
            heapq.heappush(heap, (f, next(counter), lo, ub.copy()))

        self.status = "optimal" if best_x is not None else "infeasible"
        if heap and self.nodes >= self.max_nodes:
            self.status = "iterating"  # node limit hit (reference: iters)
        x = None if best_x is None else torch.as_tensor(best_x,
                                                        device=qp.device)
        return x, best_f, self.status

    def _relax(self, qp):
        return self.qp_solver.solve(qp, self.qp_solver.init_state(qp))

    @staticmethod
    def _violations(qp, x):
        """(largest |equality residual|, smallest inequality value) over
        the present rows (0 and +inf where there are none)."""
        eq = torch.where(qp.eq_mask_, (qp.A @ x + qp.b).abs(), 0.0)
        g = torch.where(qp.ineq_mask_, qp.C @ x + qp.d, torch.inf)
        return (eq.amax() if qp.me else x.new_zeros(()),
                g.amin() if qp.mi else x.new_full((), torch.inf))

    @staticmethod
    def _obj(qp, x):
        return 0.5 * x @ (qp.Q @ x) + qp.c @ x
