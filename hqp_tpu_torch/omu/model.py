"""Model abstraction: the port's analog of the S-function/FMU host.

Port of ``hqp_tpu/omu/model.py`` (reference: hxi/Hxi_SimStruct.{h,C},
hxi/sfun_fmu.c, omu/Omu_Model.{h,C}).  A model exposes continuous states,
inputs, parameters and outputs, and the optimizer differentiates through
it.  Here a model is a class of functions written in torch ops that
``torch.func`` can transform (build vectors with ``torch.stack``), so
exact derivatives through the whole model come from ``jacfwd``; the
formulations (DynamicOpt, DynamicEst, DTOpt, DTEst) consume it.

Parameters are first-class: the estimation formulations promote them to
constant states (p' = 0), as the reference's Prg_DynamicEst does.
"""

from __future__ import annotations

import torch


class Model:
    """Dynamic model: dx = ode(t, x, u, p), y = outputs(t, x, u, p).

    Subclass and define nx/nu/ny/npar and the two functions in torch ops.
    """

    nx: int = 0
    nu: int = 0
    ny: int = 0
    npar: int = 0

    #: default parameter values (shape [npar])
    p0 = ()

    #: nominal magnitudes for scaling (reference mdl_*_nominal knobs)
    x_nominal = None
    y_nominal = None

    #: True for purely discrete-time models (dt_update instead of ode)
    discrete: bool = False

    def ode(self, t, x, u, p):
        raise NotImplementedError

    def dt_update(self, t, x, u, p):
        """Discrete-time state update x+ = f(t, x, u, p), the role of an
        S-function's mdlUpdate (consumed by the DTOpt/DTEst
        formulations, omu/Prg_DTOpt.h:1-25)."""
        raise NotImplementedError

    def outputs(self, t, x, u, p):
        """Default: outputs are the states."""
        return x

    def default_p(self, device="cuda"):
        """The default parameters [npar] as a float64 tensor on ``device``
        (the program's)."""
        return torch.as_tensor(self.p0, dtype=torch.float64,
                               device=device).reshape(self.npar)
