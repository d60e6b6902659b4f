"""Python-level SimStruct emulation.

Port of ``hqp_tpu/hxi/simstruct.py`` (host numpy, unchanged).  Role of
the reference's in-process SimStruct re-implementation
(hxi/Hxi_SimStruct.{h,C}, hxi/simstruc.h; hxi/README:17-38): models can
be written against the familiar level-2 S-function callback set without
any MathWorks installation.  Here a "Python S-function" is any object
with ``mdlInitializeSizes(S)``, ``mdlOutputs(S)`` and (optionally)
``mdlDerivatives(S)`` / ``mdlUpdate(S)`` / ``mdlInitializeConditions(S)``
methods or module-level functions operating on a :class:`PySimStruct`.

Compiled S-functions use the C twin of this structure
(``hqp_tpu_torch/csrc/hxi/hxi_sfun.h``) through
:mod:`hqp_tpu_torch.hxi.sfunction`.
"""

from __future__ import annotations

import numpy as np


class PySimStruct:
    """Mutable evaluation workspace shared between host and model.

    Mirrors csrc/hxi/hxi_sfun.h's SimStruct: sizes, time, state /
    input / output buffers and double-array parameters.
    """

    def __init__(self):
        self.nx = 0          # continuous states
        self.nxd = 0         # discrete states
        self.nu = 0
        self.ny = 0
        self.np = 0          # expected number of parameters
        self.t = 0.0
        self.sample_time = 0.0
        self.x = np.zeros(0)
        self.dx = np.zeros(0)
        self.xd = np.zeros(0)
        self.u = np.zeros(0)
        self.y = np.zeros(0)
        self.params = []     # list of float arrays
        self.errmsg = ""

    # -- Simulink-style accessors (subset) ---------------------------------
    def SetNumSFcnParams(self, n):
        self.np = n

    def GetSFcnParamsCount(self):
        return len(self.params)

    def GetSFcnParam(self, i):
        return self.params[i]

    def SetNumContStates(self, n):
        self.nx = n

    def SetNumDiscStates(self, n):
        self.nxd = n

    def SetNumInputs(self, n):
        self.nu = n

    def SetNumOutputs(self, n):
        self.ny = n

    def SetSampleTime(self, ts):
        self.sample_time = ts

    def SetErrorStatus(self, msg):
        self.errmsg = str(msg)

    # -- host side ----------------------------------------------------------
    def alloc(self):
        self.x = np.zeros(self.nx)
        self.dx = np.zeros(self.nx)
        self.xd = np.zeros(self.nxd)
        self.u = np.zeros(self.nu)
        self.y = np.zeros(self.ny)


class PySFunctionHost:
    """Drives a Python S-function through the standard callback protocol.

    Provides the same evaluator interface as :class:`hqp_tpu_torch.hxi.sfunction.
    SFunction` (sizes/derivs/outputs/update), so hosted-model wrappers
    treat Python and compiled models identically -- the role of the
    method dispatch in hxi/Hxi_SimStruct_methods.h.
    """

    def __init__(self, sfun, params=()):
        self.sfun = sfun
        self.S = PySimStruct()
        self.S.params = [np.atleast_1d(np.asarray(p, np.float64))
                         for p in params]
        self._call("mdlInitializeSizes")
        if self.S.errmsg:
            raise RuntimeError(f"mdlInitializeSizes: {self.S.errmsg}")
        self.S.alloc()
        self._call("mdlInitializeConditions", optional=True)

    def _call(self, name, optional=False):
        fn = getattr(self.sfun, name, None)
        if fn is None:
            if optional:
                return
            raise AttributeError(f"S-function lacks {name}")
        fn(self.S)
        if self.S.errmsg:
            raise RuntimeError(f"{name}: {self.S.errmsg}")

    # -- evaluator interface --------------------------------------------------
    @property
    def nx(self):
        return self.S.nx

    @property
    def nxd(self):
        return self.S.nxd

    @property
    def nu(self):
        return self.S.nu

    @property
    def ny(self):
        return self.S.ny

    def derivatives(self, t, x, u):
        S = self.S
        S.t = float(t)
        S.x[:] = x
        S.u[:] = u
        S.dx[:] = 0.0
        self._call("mdlDerivatives")
        return S.dx.copy()

    def outputs(self, t, x, u):
        S = self.S
        S.t = float(t)
        if S.nx:
            S.x[:] = x
        else:
            S.xd[:] = x
        S.u[:] = u
        S.y[:] = 0.0
        self._call("mdlOutputs")
        return S.y.copy()

    def update(self, t, xd, u):
        S = self.S
        S.t = float(t)
        S.xd[:] = xd
        S.u[:] = u
        self._call("mdlUpdate")
        return S.xd.copy()
