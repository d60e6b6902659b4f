"""Generated CUTE-style large NLP families.

Port of ``hqp_tpu/models/nlp_gen.py``: classic CUTE(st) families with
banded structure and scalable n, as :class:`~hqp_tpu_torch.docp.nlp.Nlp`
programs (the reference's CUTE bridge, hqp/Prg_CUTE.C, needs the external
SIF distribution):

* ``lqblend``   -- convex banded QP: Laplacian objective, window-sum
                   equality rows, box bounds;
* ``broydn3d``  -- Broyden tridiagonal least squares, unconstrained;
* ``bdqrtic``   -- banded quartic objective, unconstrained;
* ``catena``    -- hanging chain with nonlinear link-length equalities;
* ``srosenbr``  -- chained Rosenbrock with lower bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.nlp import Nlp
from hqp_tpu_torch.utils.registry import modules


@modules.register("prg_name", "LQBlend")
class PrgLQBlend(Nlp):
    """min 1/2 x'Tx - 1'x,  T = tridiag(-1, 2, -1);
    window-sum equalities  sum_{i in window_j} x_i = 1;  -2 <= x <= 2."""

    name = "LQBlend"

    def __init__(self, n=1000, wlen=10, device="cuda"):
        super().__init__(device)
        self.n = n
        self.wlen = wlen
        self.m = n // wlen

    def setup_vars(self):
        return dict(x_init=np.full(self.n, 0.1),
                    x_min=np.full(self.n, -2.0),
                    x_max=np.full(self.n, 2.0),
                    c_min=np.ones(self.m), c_max=np.ones(self.m))

    def f0(self, x):
        d = x[1:] - x[:-1]
        return 0.5 * ((d * d).sum() + x[0] ** 2 + x[-1] ** 2) - x.sum()

    def c(self, x):
        return x.reshape(self.m, self.wlen).sum(dim=1)


@modules.register("prg_name", "Broydn3d")
class PrgBroydn3d(Nlp):
    """Broyden tridiagonal system as least squares (CUTE BROYDN3DLS):
    r_i = (3 - 2 x_i) x_i - x_{i-1} - 2 x_{i+1} + 1, min sum r_i^2."""

    name = "Broydn3d"

    def __init__(self, n=1000, device="cuda"):
        super().__init__(device)
        self.n = n
        self.m = 0

    def setup_vars(self):
        return dict(x_init=np.full(self.n, -1.0))

    def f0(self, x):
        zero = x.new_zeros(1)
        xm = torch.cat([zero, x[:-1]])
        xp = torch.cat([x[1:], zero])
        r = (3.0 - 2.0 * x) * x - xm - 2.0 * xp + 1.0
        return (r * r).sum()


@modules.register("prg_name", "Bdqrtic")
class PrgBdqrtic(Nlp):
    """CUTE BDQRTIC: banded quartic,
    sum_{i<=n-4} (-4 x_i + 3)^2 + (x_i^2 + 2x_{i+1}^2 + 3x_{i+2}^2
                                   + 4x_{i+3}^2 + 5x_n^2)^2."""

    name = "Bdqrtic"

    def __init__(self, n=1000, device="cuda"):
        super().__init__(device)
        self.n = n
        self.m = 0

    def setup_vars(self):
        return dict(x_init=np.ones(self.n))

    def f0(self, x):
        n = self.n
        lin = (-4.0 * x[:n - 4] + 3.0) ** 2
        quad = (x[:n - 4] ** 2 + 2.0 * x[1:n - 3] ** 2
                + 3.0 * x[2:n - 2] ** 2 + 4.0 * x[3:n - 1] ** 2
                + 5.0 * x[n - 1] ** 2) ** 2
        return (lin + quad).sum()


@modules.register("prg_name", "Catena")
class PrgCatena(Nlp):
    """Hanging chain (CUTE CATENA/CHAIN): nodes y_0..y_N at fixed
    horizontal spacing h; minimize potential energy sum y_i subject to
    link length sqrt(h^2 + (y_{i+1}-y_i)^2) = L (nonlinear equalities),
    endpoints pinned at 0.  Variables: interior node heights."""

    name = "Catena"

    def __init__(self, n=1000, slack=1.2, device="cuda"):
        super().__init__(device)
        self.n = n                     # interior nodes
        self.m = n + 1                 # links
        self.h = 1.0 / (n + 1)
        self.L = slack * self.h        # each link longer than the spacing

    def setup_vars(self):
        # sagging initial guess keeps the link-length Jacobian nonsingular
        t = np.linspace(0.0, 1.0, self.n + 2)[1:-1]
        return dict(x_init=-0.2 * np.sin(np.pi * t),
                    c_min=np.full(self.m, self.L ** 2),
                    c_max=np.full(self.m, self.L ** 2))

    def f0(self, x):
        return x.sum()

    def c(self, x):
        zero = x.new_zeros(1)
        y = torch.cat([zero, x, zero])
        dy = y[1:] - y[:-1]
        return self.h ** 2 + dy * dy   # squared link lengths == L^2


@modules.register("prg_name", "SRosenbr")
class PrgSRosenbr(Nlp):
    """Chained Rosenbrock (CUTE SROSENBR) with box bounds x >= -1.5."""

    name = "SRosenbr"

    def __init__(self, n=1000, device="cuda"):
        super().__init__(device)
        self.n = n
        self.m = 0

    def setup_vars(self):
        x0 = np.tile([-1.2, 1.0], self.n // 2 + 1)[: self.n]
        return dict(x_init=x0, x_min=np.full(self.n, -1.5))

    def f0(self, x):
        e = x[1::2] - x[0::2] ** 2
        o = 1.0 - x[0::2]
        return (100.0 * e * e + o * o).sum()


FAMILIES = {
    "lqblend": PrgLQBlend,
    "broydn3d": PrgBroydn3d,
    "bdqrtic": PrgBdqrtic,
    "catena": PrgCatena,
    "srosenbr": PrgSRosenbr,
}

#: per-family Hessian strategy: the banded ill-conditioned objectives take
#: the exact Lagrangian Hessian (Hqp_HL_Gerschgorin), the Rosenbrock-type
#: ones the damped BFGS
FAMILY_HELA = {
    "lqblend": "Gerschgorin",
    "broydn3d": "Gerschgorin",
    "bdqrtic": "Gerschgorin",
    "catena": "BFGS",
    "srosenbr": "BFGS",
}


#: the Mehrotra / SparseCallbackKKT pair that every solve_generated call
#: shares, as the reference's does (hqp_tpu/models/nlp_gen.py:218-229): the
#: backend keeps its symbolic records per problem shape across calls
_SHARED = {}


def generated_solver(name: str, n: int = 1000, eps: float = 1e-6,
                     max_iters: int = 200, hela: str | None = None,
                     device="cuda"):
    """The solver ``solve_generated`` runs on one family instance on
    ``device``: SqpPowell + Mehrotra(eps=1e-9, max_iters=60) +
    :class:`~hqp_tpu_torch.qp.kkt_sparse_host.SparseCallbackKKT`, the
    pair shared across calls; ``hela = None`` picks the family default
    (FAMILY_HELA).  (The dense path stays reachable through
    ``SqpPowell(..., kkt_backend=DenseKKT())``.)"""
    from hqp_tpu_torch.qp.kkt_sparse_host import SparseCallbackKKT
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    from hqp_tpu_torch.sqp import hessian  # noqa: F401  (hela slots)
    from hqp_tpu_torch.sqp.powell import SqpPowell

    if "pair" not in _SHARED:
        _SHARED["pair"] = (Mehrotra(eps=1e-9, max_iters=60),
                           SparseCallbackKKT())
    qp_solver, backend = _SHARED["pair"]
    return SqpPowell(FAMILIES[name](n=n, device=device), max_iters=max_iters,
                     eps=eps, qp_solver=qp_solver, kkt_backend=backend,
                     hela=modules.create("sqp_hela",
                                         hela or FAMILY_HELA[name]))


def solve_generated(name: str, n: int = 1000, eps: float = 1e-6,
                    max_iters: int = 200, hela: str | None = None,
                    device="cuda"):
    """Solve one generated family instance by :func:`generated_solver`
    (init, solve) and return a summary dict.

    The KKT systems are factored on the host by the sparse LDL', as in the
    reference's ``solve_generated``, whose SQP and IP counts the port
    reproduces.  Catena's n + 1 link equalities on n heights make its
    saddle matrix singular; the LDL' floors the zero pivots at ``reg``
    (ROADMAP Q3 R12)."""
    s = generated_solver(name, n, eps, max_iters, hela, device)
    prg = s.prg
    s.init()
    result = s.solve()
    return {"problem": name, "n": prg.n, "m": prg.m, "result": result,
            "obj": float(s.f), "sqp_iters": s.iter,
            "qp_iters_total": s.qp_iters_total,
            "norm_inf": s.norm_inf, "norm_grd_L": s.norm_grd_L,
            "ok": result == "optimal"}
