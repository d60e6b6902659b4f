"""Omuses front end: continuous-time multistage programs.

Port of ``hqp_tpu/omu/program.py`` (reference: omu/Omu_Program.{h,C},
omu/Hqp_Omuses.C).  A user describes a dynamic optimization problem by

* ``setup_stages`` -- the time grid ``ts`` (K stages x sps sample periods
  over [t0, tf], omu/Omu_Program.C:853-878),
* ``setup_vars``   -- bounds and initial guesses,
* ``consistic``    -- consistent initial states of a sample period,
* ``continuous``   -- the implicit residual F(kk, t, x, u, dx) = 0,
* ``update``       -- the discrete update (f, f0, c) at the end of a sample
  period from its start state x and integrated end state xf.

The class lowers onto :class:`hqp_tpu_torch.docp.program.Docp` by
overriding the combined stage evaluation; the chain consistic ->
integrator -> update is one differentiable function and ``jacfwd``
composes its Jacobians.  The sample-period index ``kk`` is a tensor that
the stage ``vmap`` batches, so tables indexed by it go through
:func:`at` (a gather), never through Python indexing or branches.
:data:`INTEGRATIONS` counts the integrator's calls: under ``vmap`` one
call integrates one sample period of every stage of a horizon.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.docp.program import Docp
from hqp_tpu_torch.omu.integrators import RK4, Integrator

#: calls of the integrator by :meth:`OmuProgram._period` since import
#: (reset freely by callers)
INTEGRATIONS = 0


def at(table, k):
    """table[k] for a 0-d integer tensor k that vmap may batch."""
    k = torch.as_tensor(k, device=table.device)
    return table.index_select(0, k.reshape(1)).reshape(table.shape[1:])


class OmuProgram(Docp):
    """Continuous-time multistage program over an exchangeable integrator."""

    sps: int = 1          # sample periods per stage (stages_alloc 'sps')
    t0: float = 0.0
    tf: float = 1.0

    def __init__(self, integrator: Integrator | None = None, device="cuda"):
        super().__init__(device)
        self.integrator = integrator if integrator is not None else RK4()
        self.ts = None

    # -- user interface ------------------------------------------------------

    def setup_stages(self):
        """Default uniform grid (omu/Omu_Program.C stages_alloc), by
        numpy's linspace on the host (the reference's jnp.linspace may
        round some points one ulp apart)."""
        KK = self.K * self.sps
        self.ts = self._t(np.linspace(self.t0, self.tf, KK + 1))

    def consistic(self, kk, t, x, u):
        """Consistent initial states of a sample period (default: pass x)."""
        return x

    def continuous(self, kk, t, x, u, dx):
        """Implicit residual F(kk, t, x, u, dx); components never written
        stay 0, meaning xdot = 0 for explicit integrators."""
        return torch.zeros_like(x)

    def update(self, kk, x, u, xf):
        """Discrete update at the end of sample period kk: (f, f0, c); the
        default passes the integrated state through."""
        return xf, xf.new_zeros(()), xf.new_zeros((self.mc,))

    def has_continuous(self) -> bool:
        return True

    # -- lowering onto Docp --------------------------------------------------

    def setup(self):
        self.setup_stages()
        # per-sample-period constraint rows: each of a stage's sps periods
        # keeps its own mc rows (omu/Hqp_Omuses.C:566-780), so the stage
        # arrays are sps * mc wide; the terminal pseudo-stage fills only
        # its first block and the rest is masked by infinite bounds
        if not hasattr(self, "_mc_user"):
            self._mc_user = self.mc
        self.mc = self._mc_user * (self.sps if self._mc_user else 1)
        return super().setup()

    def _setup_vars_processed(self):
        # user code (setup_vars) sees the per-period constraint count; the
        # assembly (Docp.setup) sees the widened stage-level count
        self.mc = self._mc_user
        try:
            v = dict(self.setup_vars())
        finally:
            self.mc = self._mc_user * (self.sps if self._mc_user else 1)
        mcu, sps = self._mc_user, self.sps
        if mcu and sps > 1:
            for key in ("c_min", "c_max"):
                a = v.get(key)
                if a is None:
                    continue
                a = np.asarray(a, np.float64).reshape(self.K + 1, mcu)
                wide = np.tile(a, (1, sps))
                wide[-1, mcu:] = -np.inf if key == "c_min" else np.inf
                v[key] = wide
        return v

    def _period(self, kk, t0k, t1k, x, u):
        global INTEGRATIONS
        x0 = self.consistic(kk, t0k, x, u)
        if self.has_continuous():
            INTEGRATIONS += 1
            xf = self.integrator.solve(self.continuous, kk, t0k, t1k, x0, u)
        else:
            xf = x0
        return self.update(kk, x0, u, xf)

    def stage_all(self, k, x, u):
        """Chain the stage's sample periods; constraint rows concatenate
        per period (one block per kk, omu/Hqp_Omuses.C:566-780)."""
        f0sum = x.new_zeros(())
        cs = []
        xcur = x
        for j in range(self.sps):
            kk = k * self.sps + j
            f, f0, c = self._period(kk, at(self.ts, kk), at(self.ts, kk + 1),
                                    xcur, u)
            f0sum = f0sum + f0
            cs.append(torch.atleast_1d(c))
            xcur = f
        call = torch.cat(cs) if self._mc_user else x.new_zeros((self.mc,))
        return xcur, f0sum, call

    def stage_final(self, x, u):
        """Terminal stage: update() with kk = KK and xf = x, no dynamics.
        Rows beyond the first per-period block are padding."""
        KK = torch.as_tensor(self.K * self.sps, device=x.device)
        x0 = self.consistic(KK, self.ts[-1], x, u)
        _, f0, c = self.update(KK, x0, u, x0)
        c = torch.atleast_1d(c)
        if self._mc_user and self.sps > 1:
            c = torch.cat([c, c.new_zeros(((self.sps - 1) * self._mc_user,))])
        return f0, c
