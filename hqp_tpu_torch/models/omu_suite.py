"""Further Omuses example programs from the reference's odc suite.

Port of ``hqp_tpu/models/omu_suite.py``: BatchReactor
(odc/Prg_BatchReactor.C), Bio (odc/Prg_Bio.C), TP383omu
(odc/Prg_TP383omu.C), HS99omu (odc/Prg_HS99omu.C) and CranePar
(odc/Prg_CranePar.{h,C}).  Coefficient tables live on the program's
device and are read through :func:`hqp_tpu_torch.omu.program.at`, since
the stage index they are read at is batched.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.program import Docp
from hqp_tpu_torch.omu.integrators import IMP, RK4
from hqp_tpu_torch.omu.program import OmuProgram, at
from hqp_tpu_torch.utils.registry import modules


@modules.register("prg_name", "BatchReactor")
class PrgBatchReactor(OmuProgram):
    """Optimal control of a batch reactor (odc/Prg_BatchReactor.C):
    maximize final product x2 with reaction x1 -> x2, control bounds
    0 <= u <= 5; f* = -0.57354 for kinf = 0.5, K = 40."""

    name = "BatchReactor"
    nx = 2
    nu = 1
    mc = 0
    t0, tf = 0.0, 1.0

    def __init__(self, K=40, kinf=0.5, integrator=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=4), device)
        self.K = K
        self.kinf = kinf

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        x_min = np.full((K1, 2), -np.inf)
        x_max = np.full((K1, 2), np.inf)
        x_init = np.full((K1, 2), 0.5)
        x_min[0] = x_max[0] = x_init[0] = (1.0, 0.0)
        x_min[1:] = 0.0
        x_max[1:, 1] = 1.0
        return dict(
            x_min=x_min, x_max=x_max, x_init=x_init,
            u_min=np.zeros((K, 1)), u_max=np.full((K, 1), 5.0),
            u_init=np.ones((K, 1)),
        )

    def continuous(self, kk, t, x, u, dx):
        F0 = -(u[0] + self.kinf * u[0] * u[0]) * x[0] - dx[0]
        F1 = u[0] * x[0] - dx[1]
        return torch.stack([F0, F1])

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        f0 = torch.where(kk >= KK, -x[1], 0.0)
        return xf, f0, x.new_zeros((0,))


@modules.register("prg_name", "Bio")
class PrgBio(OmuProgram):
    """Fed-batch fermentation process (odc/Prg_Bio.C, Pfaff 1991):
    maximize product profit minus substrate cost; states (product mass,
    added substrate), control = substrate inflow in [0, 0.1]."""

    name = "Bio"
    nx = 2
    nu = 1
    mc = 0

    def __init__(self, K=51, tf=10.0, cs0=5.0, uinit=0.01,
                 integrator=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else IMP(steps=4), device)
        self.K = K
        self.t0, self.tf = 0.0, tf
        # kinetic and stochiometric parameters (Prg_Bio.C:66-85)
        self.pimax, self.ks, self.kis, self.kip = 0.16, 1.0, 160.0, 75.0
        self.kd, self.yps, self.kappa, self.cdos = 0.006, 0.55, 600.0, 750.0
        self.kp, self.kap, self.kos = 0.08, 0.1, 0.02
        self.cs0 = cs0
        self.v0 = 5.0
        self.p0 = 0.0
        self.x0m = 30.0 * self.v0
        self.Fsmin, self.Fsmax = 0.0, 0.1
        self.uinit = uinit

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        x_min = np.full((K1, 2), -np.inf)
        x_max = np.full((K1, 2), np.inf)
        x_init = np.zeros((K1, 2))
        x_min[0] = x_max[0] = x_init[0] = (self.p0, 0.0)
        x_min[1:] = 0.0
        return dict(
            x_min=x_min, x_max=x_max, x_init=x_init,
            u_min=np.full((K, 1), self.Fsmin),
            u_max=np.full((K, 1), self.Fsmax),
            u_init=np.full((K, 1), self.uinit),
        )

    def _concentrations(self, x):
        v = self.v0 + (x[0] - self.p0) / self.kappa + x[1]
        s = self.cs0 * self.v0 - (x[0] - self.p0) / self.yps \
            + self.cdos * x[1]
        # the reference's jnp.maximum, whose derivative splits at a tie:
        # cp is exactly 0 at the fixed start (x0 = p0 = 0), where
        # torch.clamp's would be 1 (a Rosenbrock step reads it).  The zero
        # is v - v so that under forward mode it carries a tangent: an op
        # of a tangent-carrying tensor with one that carries none takes
        # PyTorch's slow Python path
        zero = v - v
        cs = torch.maximum(s / v, zero)
        cp = torch.maximum(x[0] / v, zero)
        return cs, cp

    def continuous(self, kk, t, x, u, dx):
        cs, cp = self._concentrations(x)
        Pi = self.x0m * self.pimax * torch.exp(-self.kd * t - cp / self.kip) \
            * cs / (self.ks + cs + cs * cs / self.kis)
        return torch.stack([Pi - dx[0], u[0] - dx[1]])

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        f0 = torch.where(
            kk >= KK,
            -((self.kp + self.kap / self.kappa) * x[0]
              - (self.kos * self.cdos + self.kap) * x[1]
              - self.kap * self.v0 + self.kap / self.kappa * self.p0),
            0.0)
        return xf, f0, x.new_zeros((0,))


_TP383_A = [12842.275, 634.25, 634.25, 634.125, 1268.0, 633.875, 633.75,
            1267.0, 760.05, 633.25, 1266.25, 632.875, 394.46, 940.838]
_TP383_C = [5.47934, 0.83234, 0.94749, 1.11082, 2.64824, 1.55868, 1.73215,
            3.90896, 2.74284, 2.60541, 5.96184, 3.29522, 1.83517, 2.81372]


@modules.register("prg_name", "TP383omu")
class PrgTP383omu(Docp):
    """TP383 as a 14-stage multistage program (odc/Prg_TP383omu.C):
    state s accumulates sum c_k u_k (s0 = 0 fixed, sK = 1 fixed), stage
    cost a_k/u_k, per-stage control bounds.  Same optimum as the
    stage-free TP383."""

    name = "TP383omu"
    nx = 1
    nu = 1
    mc = 0
    K = 14

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._a = self._t(_TP383_A)
        self._c = self._t(_TP383_C)

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        x_min = np.full((K1, 1), -np.inf)
        x_max = np.full((K1, 1), np.inf)
        x_min[0] = x_max[0] = 0.0
        x_min[K] = x_max[K] = 1.0
        u_max = np.full((K, 1), 0.03)
        u_max[:5] = 0.04
        return dict(
            x_min=x_min, x_max=x_max, x_init=np.zeros((K1, 1)),
            u_min=np.full((K, 1), 1e-6), u_max=u_max,
            u_init=np.full((K, 1), 0.01))

    def f(self, k, x, u):
        return x + at(self._c, k) * u

    def f0(self, k, x, u):
        a = at(self._a, torch.clamp(k, max=self.K - 1))
        return torch.where(k < self.K, a / torch.clamp(u[0], min=1e-12), 0.0)


@modules.register("prg_name", "HS99omu")
class PrgHS99omu(OmuProgram):
    """HS99 as a 7-stage continuous-time program (odc/Prg_HS99omu.C):
    states (r, q, s) integrate the rocket dynamics r' = a cos(u),
    q' = s, s' = a sin(u) - b over the non-uniform grid T; terminal
    q = 1e5, s = 1e3 fixed; f0 = -r(tK)^2."""

    name = "HS99omu"
    nx = 3
    nu = 1
    mc = 0
    K = 7

    _A = [0.0, 50.0, 50.0, 75.0, 75.0, 75.0, 100.0, 100.0]
    _T = [0.0, 25.0, 50.0, 100.0, 150.0, 200.0, 290.0, 380.0]
    _b = 32.0

    def __init__(self, integrator=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=2), device)
        self._a = self._t(self._A)

    def setup_stages(self):
        # non-uniform measurement grid (stages_alloc with explicit ts)
        self.ts = self._t(self._T)

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        x_min = np.full((K1, 3), -np.inf)
        x_max = np.full((K1, 3), np.inf)
        x_min[0] = x_max[0] = 0.0
        x_min[K, 1] = x_max[K, 1] = 1e5
        x_min[K, 2] = x_max[K, 2] = 1e3
        return dict(
            x_min=x_min, x_max=x_max, x_init=np.zeros((K1, 3)),
            u_min=np.zeros((K, 1)), u_max=np.full((K, 1), 1.58),
            u_init=np.full((K, 1), 0.5))

    def continuous(self, kk, t, x, u, dx):
        a = at(self._a, torch.clamp(kk + 1, max=self.K))
        return torch.stack([a * torch.cos(u[0]) - dx[0],
                            x[2] - dx[1],
                            a * torch.sin(u[0]) - self._b - dx[2]])

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        f0 = torch.where(kk >= KK, -x[0] * x[0], 0.0)
        return xf, f0, x.new_zeros((0,))


@modules.register("prg_name", "CranePar")
class PrgCranePar(OmuProgram):
    """Crane load-mass and initial-state estimation
    (odc/Prg_CranePar.{h,C} + odc/cranepar.tcl): state
    [m, phi, omega, v, s] with m = ml/1000 a constant parameter state,
    constant control u = -1, least-squares fit of the trolley position s
    to measurements.  Without a given record (``s_ref``) the measurements
    are generated by simulating the true model (ml = 4000) on the
    program's device and adding seeded uniform noise (prg_disturb)."""

    name = "CranePar"
    nx = 5
    nu = 0
    mc = 0

    def __init__(self, K=25, tf=5.0, maxdev=0.05, seed=1234,
                 integrator=None, Fscale=1000.0, g=9.81, l=10.0, md=1000.0,
                 ml=4000.0, s_ref=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=4), device)
        self.K = K
        self.t0, self.tf = 0.0, float(tf)
        self.maxdev, self.seed = maxdev, seed
        self.Fscale, self.g, self.l, self.md, self.ml = Fscale, g, l, md, ml
        self.x0_true = np.array([ml / 1000.0, 0.0, 0.0, 0.0, 25.0])
        self.s_ref = None if s_ref is None else \
            np.asarray(s_ref, np.float64).copy()

    def _model_eq(self, t, x):
        m, phi, omega, v = x[0], x[1], x[2], x[3]
        ml = 1000.0 * m
        mdl = self.md + ml
        u_control = -1.0
        sinphi = torch.sin(phi)
        den = self.md + ml * sinphi ** 2
        g, l, Fs = self.g, self.l, self.Fscale
        dphi = omega
        domega = -(mdl * g * sinphi
                   + 0.5 * ml * l * omega ** 2 * torch.sin(2 * phi)
                   + u_control * Fs * torch.cos(phi)) / (l * den)
        dv = (0.5 * ml * g * torch.sin(2 * phi)
              + ml * l * omega ** 2 * sinphi + u_control * Fs) / den
        return torch.stack([torch.zeros_like(m), dphi, domega, dv, v])

    def continuous(self, kk, t, x, u, dx):
        return self._model_eq(t, x) - dx

    def disturb(self):
        """Seeded uniform noise on the record (prg_disturb,
        odc/Prg_CranePar.C:107-117)."""
        rng = np.random.RandomState(self.seed)
        self.s_ref = self.s_ref + self.maxdev * (
            rng.rand(self.s_ref.shape[0]) * 2.0 - 1.0)

    def setup(self):
        self.setup_stages()
        if self.s_ref is None:
            # the record of the true model: one sample-period rollout on
            # the device, read back once
            x = self._t(self.x0_true)
            u = x.new_zeros((0,))
            rec = [x[4]]
            for kk in range(self.K * self.sps):
                x = self.integrator.solve(self.continuous, kk, self.ts[kk],
                                          self.ts[kk + 1], x, u)
                rec.append(x[4])
            self.s_ref = torch.stack(rec).cpu().numpy()
            self.disturb()
        self._s_ref = self._t(self.s_ref)
        return super().setup()

    def setup_vars(self):
        return dict(x_init=np.tile(self.x0_true, (self.K + 1, 1)))

    def update(self, kk, x, u, xf):
        r = x[4] - at(self._s_ref, torch.clamp(kk, max=self.K * self.sps))
        return xf, r * r, x.new_zeros((0,))
