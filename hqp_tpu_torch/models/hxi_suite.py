"""Example programs over hosted (external) models.

Port of ``hqp_tpu/models/hxi_suite.py``: the reference's S-function/FMU
example problems from odc/runallhxi: DID_SFunction (discrete double
integrator through the binary S-function path, odc/did_sfunction.tcl +
odc/sfun_did.c), DIC_SFunction (continuous double integrator,
odc/sfun_dic.c), DID_MEX (DID through a MEX-built S-function), and the
FMU variant (odc/dic_fmu_est.tcl role).  Each solves the same optimal
control problem as its native twin (DID, DIC), so objective parity
between the native and hosted paths is directly testable.
"""

from __future__ import annotations

import numpy as np
import torch

from hqp_tpu_torch.hxi.fmu import Fmu, build_test_fmu
from hqp_tpu_torch.hxi.mex import MexEvaluator, demo_mex_path
from hqp_tpu_torch.hxi.sfunction import SFunction, demo_sfunction_path
from hqp_tpu_torch.models.did import PrgDID
from hqp_tpu_torch.omu.hosted import HostedModel
from hqp_tpu_torch.omu.integrators import RK4
from hqp_tpu_torch.omu.program import OmuProgram
from hqp_tpu_torch.utils.registry import modules


@modules.register("prg_name", "DID_SFunction")
class PrgDIDSFunction(PrgDID):
    """DID solved through a hosted binary S-function (sfun_did.c): the
    stage map is the S-function's mdlUpdate, derivatives come from host
    finite differences -- the reference's DID_SFunction example."""

    name = "DID_SFunction"

    def __init__(self, kmax: int = 60, with_cns: bool = True,
                 device="cuda"):
        super().__init__(kmax=kmax, with_cns=with_cns, device=device)
        ev = SFunction(demo_sfunction_path("sfun_did"), params=[[self.dt]])
        self.hosted = HostedModel(ev)

    def f(self, k, x, u):
        return self.hosted.dt_update(k * self.dt, x, u, ())


@modules.register("prg_name", "DID_MEX")
class PrgDIDMex(PrgDID):
    """DID solved through a MEX-BUILT S-function: the in-tree demo
    source (csrc/hxi_simulink/sfun_did_demo.c) compiled with
    -DMATLAB_MEX_FILE exports only ``mexFunction``; the hosting goes
    through the method-table protocol (hqp_tpu_torch.hxi.mex, the
    Hxi_MEX_SFunction role).  The parameter arrives as MATLAB-style
    argument text through the mx parser (Hxi_mx_parse role), the text the
    reference writes, so dt reaches the model bit for bit."""

    name = "DID_MEX"

    def __init__(self, kmax: int = 60, with_cns: bool = True,
                 device="cuda"):
        super().__init__(kmax=kmax, with_cns=with_cns, device=device)
        ev = MexEvaluator(demo_mex_path(), args=f"[{self.dt}]")
        self.hosted = HostedModel(ev)

    def f(self, k, x, u):
        return self.hosted.dt_update(k * self.dt, x, u, ())


class _DICBase(OmuProgram):
    """Continuous-time double integrator, the continuous counterpart of
    DID (odc DIC examples): states (v, s), dv = u, ds = v, cost
    integral u^2 dt; boundary conditions follow Prg_DID:
    x(0) = (1, 0), x(1) = (-1, 0), path bound s <= 0.01."""

    nx = 2
    nu = 1
    mc = 0
    t0, tf = 0.0, 1.0

    def __init__(self, K: int = 20, integrator=None, device="cuda"):
        super().__init__(integrator if integrator is not None
                         else RK4(steps=2), device)
        self.K = K

    def setup_vars(self):
        K, K1 = self.K, self.K + 1
        inf = np.inf
        x_min = np.full((K1, 2), -inf)
        x_max = np.full((K1, 2), inf)
        x_min[0] = x_max[0] = (1.0, 0.0)
        x_max[1:K, 1] = 0.01
        x_min[K] = x_max[K] = (-1.0, 0.0)
        return dict(
            x_min=x_min, x_max=x_max,
            x_init=np.tile((1.0, 0.0), (K1, 1)),
            u_init=np.full((K, 1), -2.0),
        )

    def update(self, kk, x, u, xf):
        KK = self.K * self.sps
        dt = (self.tf - self.t0) / KK
        f0 = torch.where(kk >= KK, 0.0, u[0] * u[0] * dt)
        return xf, f0, x.new_zeros((0,))


@modules.register("prg_name", "DIC")
class PrgDIC(_DICBase):
    """Continuous double integrator in torch ops (reference DIC family)."""

    name = "DIC"

    def continuous(self, kk, t, x, u, dx):
        return torch.stack([u[0] - dx[0], x[0] - dx[1]])


@modules.register("prg_name", "DIC_SFunction")
class PrgDICSFunction(_DICBase):
    """DIC through a hosted binary S-function (sfun_dic.c): the ODE is
    the S-function's mdlDerivatives, evaluated on the host with finite
    difference Jacobians -- the reference's DIC_SFunction example."""

    name = "DIC_SFunction"

    def __init__(self, K: int = 20, mass: float = 1.0, integrator=None,
                 device="cuda"):
        super().__init__(K=K, integrator=integrator, device=device)
        ev = SFunction(demo_sfunction_path("sfun_dic"), params=[[mass]])
        self.hosted = HostedModel(ev)

    def continuous(self, kk, t, x, u, dx):
        return self.hosted.ode(t, x, u, ()) - dx


@modules.register("prg_name", "DIC_FMU")
class PrgDICFMU(_DICBase):
    """DIC through a hosted FMI 2.0 FMU with analytic directional
    derivatives (the reference's FMU path, hxi/sfun_fmu.c +
    odc/dic_fmu_est.tcl role).  Builds the test FMU when no path is
    given."""

    name = "DIC_FMU"

    def __init__(self, K: int = 20, fmu_path: str | None = None,
                 mass: float = 1.0, integrator=None, device="cuda"):
        super().__init__(K=K, integrator=integrator, device=device)
        if fmu_path is None:
            fmu_path = build_test_fmu()
        self.fmu = Fmu(fmu_path, params={"m": mass})
        self.hosted = HostedModel(self.fmu)

    def continuous(self, kk, t, x, u, dx):
        return self.hosted.ode(t, x, u, ()) - dx
