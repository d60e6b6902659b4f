"""Container crane minimum-time maneuver (odc/Prg_Crane.C).

Port of ``hqp_tpu/models/crane.py``.  Free final time via the time-scale
state x[0] = tf (constant through the horizon, minimized at the end);
piecewise-linear control through the expansion state x[5] with rate input
u; pendulum dynamics with bounds on the swing angle and trolley position.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.omu.integrators import RK4
from hqp_tpu_torch.omu.program import OmuProgram
from hqp_tpu_torch.utils.registry import modules

_PI = 3.14159


@modules.register("prg_name", "Crane")
class PrgCrane(OmuProgram):
    """States: [tf, phi, omega, v, s, u_ctrl]; input: du/dt.
    Parity: odc/Prg_Crane.C:17-203."""

    name = "Crane"
    nx = 6
    nu = 1
    mc = 0
    offs = 1

    def __init__(self, K=50, tf_guess=15.0, u_bound=5.0,
                 phi_bound=5.0 / 180.0 * _PI, integrator=None,
                 Fscale=1000.0, g=9.81, l=10.0, md=1000.0, ml=4000.0,
                 device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=4), device)
        self.K = K
        self.tf_guess = tf_guess
        self.u_bound = u_bound
        self.phi_bound = phi_bound
        self.Fscale, self.g, self.l, self.md, self.ml = Fscale, g, l, md, ml
        self.mdl = md + ml

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        inf = np.inf
        x_min = np.full((K1, 6), -inf)
        x_max = np.full((K1, 6), inf)
        x_init = np.zeros((K1, 6))
        u_init = np.zeros((self.K, 1))

        # initial state constraints: phi, omega, v = 0; s = 25
        x_min[0, 1:5] = x_max[0, 1:5] = (0.0, 0.0, 0.0, 25.0)
        # final state constraints
        x_min[K, 1:5] = x_max[K, 1:5] = (0.0, 0.0, 0.0, 0.0)
        # path bounds for phi and s
        x_min[1:K, 1] = -self.phi_bound
        x_max[1:K, 1] = self.phi_bound
        x_min[1:K, 4] = 0.0
        x_max[1:K, 4] = 25.0
        # lower bound on final time, control bounds on the u-state
        x_min[:, 0] = 1.0
        x_min[:, 5] = -self.u_bound
        x_max[:, 5] = self.u_bound

        # initial solution (odc/Prg_Crane.C:105-123)
        x_init[:, 0] = self.tf_guess
        x_init[0, 1:5] = (0.0, 0.0, 0.0, 25.0)
        u_guess = 100.0 * self.mdl / self.Fscale / self.tf_guess ** 2
        half = self.K // 2
        x_init[:half + 1, 5] = -u_guess
        x_init[half + 1:, 5] = u_guess
        u_init[half, 0] = 2.0 * u_guess / (self.tf_guess / self.K)

        return dict(x_min=x_min, x_max=x_max, x_init=x_init, u_init=u_init)

    def model_eq(self, t, x, u):
        """Pendulum/trolley dynamics (odc/Prg_Crane.C:178-203)."""
        phi, omega, v = x[1], x[2], x[3]
        u_control = x[5]
        sinphi = torch.sin(phi)
        den = self.md + self.ml * sinphi ** 2
        mdl, g, l, Fs = self.mdl, self.g, self.l, self.Fscale
        dphi = omega
        domega = -(mdl * g * sinphi
                   + 0.5 * self.ml * l * omega ** 2 * torch.sin(2 * phi)
                   + u_control * Fs * torch.cos(phi)) / (l * den)
        dv = (0.5 * self.ml * g * torch.sin(2 * phi)
              + self.ml * l * omega ** 2 * sinphi + u_control * Fs) / den
        return torch.stack([torch.zeros_like(phi), dphi, domega, dv, v,
                            u[0]])

    def continuous(self, kk, t, x, u, dx):
        tscale = x[0]
        xp = self.model_eq(tscale * t, x, u)
        # F[0] stays 0 (tf constant); scaled dynamics for the rest
        return torch.cat([torch.zeros_like(x[:1]), tscale * xp[1:] - dx[1:]])

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        f = torch.cat([x[:1], xf[1:]])    # constant final time passes through
        f0 = torch.where(kk >= KK, x[0], 0.0)   # minimize tf at the end
        return f, f0, x.new_zeros((0,))
