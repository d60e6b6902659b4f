"""MEX S-function hosting (Hxi_MEX_SFunction role).

Port of ``hqp_tpu/hxi/mex.py``.  The reference loads MATLAB-MEX-compiled
S-functions -- shared objects whose ONLY entry point is ``mexFunction``
-- by smuggling its emulated SimStruct pointer through the MEX calling
convention and harvesting the method pointers the gateway registers
(hxi/Hxi_MEX_SFunction.C:235-370; configure.in:457-460).  Same design
here, on the port's own sources (``csrc/hxi_simulink``):

* ``build_mex_sfunction(src)`` compiles an UNMODIFIED level-2 C
  S-function source with ``-DMATLAB_MEX_FILE`` so its trailing
  ``#include "simulink.c"`` pulls in the gateway twin instead of the
  cg_sfun.h export shims -- the built object exports ``mexFunction`` and
  nothing else of the S-function;
* the host-support library (``mex_host.c`` -> ``libhximexhost.so``,
  built on first use) allocates the SimStruct, performs the flag-0
  initialization call and drives the registered method table;
* :class:`MexSFunction` exposes the same driving surface as
  :class:`hqp_tpu_torch.hxi.simulink.SimulinkSFunction`, and
  :class:`MexEvaluator` the evaluator protocol that
  :class:`hqp_tpu_torch.omu.hosted.HostedModel` takes.

All three builds go to ``build/hqp_tpu_torch_hxi/<hash>/`` by
:func:`hqp_tpu_torch.hxi.sfunction.cc_shared` (temporary name, then
rename; a failed build raises).  Parameters may be given as Python values
or as MATLAB-style argument text parsed by
:mod:`hqp_tpu_torch.hxi.mx_parse` (Hxi_mx_parse.h role); string
parameters are stored as char-code arrays readable through the
emulation's mxIsChar/mxGetString.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from hqp_tpu_torch.hxi.mx_parse import parse_args
from hqp_tpu_torch.hxi.simulink import (SIMULINK_DIR, SS_SIGS,
                                        EmulatedSFunction, bind,
                                        build_emulated)

_dp = ctypes.POINTER(ctypes.c_double)
_S = ctypes.c_void_p

#: the host library's entry points beside the SimStruct accessors
_MEX_SIGS = {
    "hxi_ss_set_param_char": (None, [_S, ctypes.c_int, _dp, ctypes.c_int,
                                     ctypes.c_int]),
    "hxi_mex_init": (ctypes.c_int, [_S, ctypes.c_void_p]),
    "hxi_mex_initializeSampleTimes": (None, [_S]),
    "hxi_mex_initializeConditions": (None, [_S]),
    "hxi_mex_start": (None, [_S]),
    "hxi_mex_outputs": (None, [_S, ctypes.c_int]),
    "hxi_mex_update": (None, [_S, ctypes.c_int]),
    "hxi_mex_derivatives": (None, [_S]),
    "hxi_mex_jacobian": (None, [_S]),
    "hxi_mex_terminate": (None, [_S]),
    "hxi_mex_has_update": (ctypes.c_int, [_S]),
    "hxi_mex_has_derivatives": (ctypes.c_int, [_S]),
    "hxi_mex_has_jacobian": (ctypes.c_int, [_S]),
}


def build_mex_sfunction(src: str, out: str | None = None,
                        include_dir: str | None = None) -> str:
    """Compile a level-2 C S-function source as a MEX file (the
    -DMATLAB_MEX_FILE branch of its trailing include), at ``out`` if
    given, else under ``build/``."""
    name = os.path.splitext(os.path.basename(src))[0] + ".mexa64"
    return build_emulated(src, name, defines=("-DMATLAB_MEX_FILE",),
                          include_dir=include_dir, out=out)


def demo_mex_path() -> str:
    """The in-tree demo S-function (csrc/hxi_simulink/sfun_did_demo.c),
    built as a MEX file on demand."""
    return build_mex_sfunction(os.path.join(SIMULINK_DIR,
                                            "sfun_did_demo.c"))


_host_lib_cache = None


def _host_lib():
    """Build + load libhximexhost.so once per process."""
    global _host_lib_cache
    if _host_lib_cache is None:
        so = build_emulated(os.path.join(SIMULINK_DIR, "mex_host.c"),
                            "libhximexhost.so")
        _host_lib_cache = bind(ctypes.CDLL(so), {**SS_SIGS, **_MEX_SIGS})
    return _host_lib_cache


class MexSFunction(EmulatedSFunction):
    """A MEX-built level-2 S-function driven through the method table.

    Same public surface as SimulinkSFunction (outputs/update/
    derivatives/jacobian/xd/xc/set_inputs/sample_time)."""

    _what = "MEX S-function"

    def __init__(self, mex_path: str, params=(), args: str | None = None):
        self._mex = ctypes.CDLL(mex_path)
        mexfn = ctypes.cast(self._mex.mexFunction, ctypes.c_void_p)
        lib = _host_lib()
        self._lib = lib
        self._outputs = lib.hxi_mex_outputs
        self._update = lib.hxi_mex_update
        self._derivatives = lib.hxi_mex_derivatives
        self._jacobian = lib.hxi_mex_jacobian
        if args is not None:
            params = parse_args(args)
        self.S = lib.hxi_ss_create()
        self._params = []
        for i, p in enumerate(params):
            if isinstance(p, str):
                arr = np.asarray([float(ord(c)) for c in p], np.float64)
                self._params.append(arr)
                lib.hxi_ss_set_param_char(self.S, i, arr.ctypes.data_as(_dp),
                                          1, arr.size)
            else:
                arr = np.ascontiguousarray(np.atleast_1d(p), np.float64)
                self._params.append(arr)
                lib.hxi_ss_set_param(self.S, i, arr.ctypes.data_as(_dp),
                                     arr.size, 1)
        # the order matters: the flag-0 gateway call sizes the SimStruct
        # and registers the methods before the buffers exist
        rc = lib.hxi_mex_init(self.S, mexfn)
        self._check()
        if rc:
            raise RuntimeError(f"hxi_mex_init failed (rc {rc})")
        lib.hxi_ss_allocate(self.S)
        lib.hxi_mex_initializeSampleTimes(self.S)
        lib.hxi_mex_initializeConditions(self.S)
        lib.hxi_mex_start(self.S)
        self._check()

        self._sizes()
        self.has_update = bool(lib.hxi_mex_has_update(self.S))
        self.has_derivatives = bool(lib.hxi_mex_has_derivatives(self.S))
        self.has_jacobian = bool(lib.hxi_mex_has_jacobian(self.S))

    def terminate(self):
        self._lib.hxi_mex_terminate(self.S)

    def __del__(self):  # pragma: no cover - GC order dependent
        try:
            self._lib.hxi_ss_destroy(self.S)
        except Exception:
            pass


class MexEvaluator:
    """Evaluator-protocol adapter over a MEX S-function, so
    :class:`hqp_tpu_torch.omu.hosted.HostedModel` (and the formulations
    above it) host MEX binaries exactly like the other hxi evaluators:
    attributes nx/nxd/nu/ny plus stateless update/derivatives/outputs (the
    state is written into the SimStruct buffers per call)."""

    def __init__(self, mex_path: str, params=(), args: str | None = None):
        if mex_path.endswith(".c"):
            mex_path = build_mex_sfunction(mex_path)
        self.sf = MexSFunction(mex_path, params=params, args=args)
        self.nx = self.sf.ncont
        self.nxd = self.sf.ndisc
        self.nu = self.sf.nin
        self.ny = self.sf.nout
        self.sample_time = self.sf.sample_time()

    def _load(self, x, u):
        sf = self.sf
        if self.nx:
            sf.xc[:] = np.asarray(x, np.float64)[: self.nx]
        if self.nxd:
            sf.xd[:] = np.asarray(x, np.float64)[: self.nxd]
        sf.set_inputs(u)

    def update(self, t, x, u):
        self._load(x, u)
        self.sf.update(float(t))
        return self.sf.xd.copy()

    def derivatives(self, t, x, u):
        self._load(x, u)
        return self.sf.derivatives(float(t))

    def outputs(self, t, x, u):
        self._load(x, u)
        return self.sf.outputs(float(t))
