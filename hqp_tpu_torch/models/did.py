"""Double integrator with state constraint (DID).

Port of ``hqp_tpu/models/did.py`` (reference: hqp_docp/Prg_DID.{h,C}):

    states  x = (velocity-like, position-like), control u = acceleration
    dynamics (exact discretization, dt = 1/K):
        f_0 = x_0 + u dt,   f_1 = x_0 dt + x_1 + u dt^2/2
    cost    sum u^2 dt
    x(0) = (1, 0) fixed, x(K) = (-1, 0) fixed, path bound x_1 <= 0.01,
    optional extra path constraint c = x_1 + dt/2 x_0 <= 0.01.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.program import Docp
from hqp_tpu_torch.utils.registry import modules


@modules.register("prg_name", "DID")
class PrgDID(Docp):
    """Parity target: hqp_docp/Prg_DID.C (kmax=60 default, with_cns=True)."""

    name = "DID"
    nx = 2
    nu = 1
    mc = 1

    def __init__(self, kmax: int = 60, with_cns: bool = True,
                 device="cuda"):
        super().__init__(device)
        self.K = kmax
        self.with_cns = with_cns
        self.dt = 1.0 / kmax
        if not with_cns:
            self.mc = 0

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        inf = np.inf
        x_min = np.full((K1, 2), -inf)
        x_max = np.full((K1, 2), inf)
        x_min[0] = x_max[0] = (1.0, 0.0)      # initial state (Prg_DID.C:51-54)
        x_max[1:K, 1] = 0.01                  # path bound (Prg_DID.C:55-58)
        x_min[K] = x_max[K] = (-1.0, 0.0)     # final state (Prg_DID.C:59-63)
        out = dict(x_min=x_min, x_max=x_max,
                   x_init=np.tile((1.0, 0.0), (K1, 1)),
                   u_init=np.full((K, 1), -2.0))
        if self.with_cns:
            c_min = np.full((K1, 1), -inf)
            c_max = np.full((K1, 1), inf)
            c_max[:K, 0] = 0.01
            out["c_min"] = c_min
            out["c_max"] = c_max
        return out

    def f(self, k, x, u):
        dt = self.dt
        return torch.stack([x[0] + u[0] * dt,
                            x[0] * dt + x[1] + u[0] * 0.5 * dt * dt])

    def f0(self, k, x, u):
        return u[0] * u[0] * self.dt

    def c(self, k, x, u):
        if not self.with_cns:
            return x.new_zeros((0,))
        return torch.stack([x[1] + 0.5 * self.dt * x[0]])
