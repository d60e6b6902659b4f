"""Simulink-compatible level-2 S-function hosting.

Port of ``hqp_tpu/hxi/simulink.py``.  The reference compiles UNMODIFIED
level-2 C S-function sources against its in-tree SimStruct emulation
(hxi/Hxi_SimStruct.h; hxi/README:17-38), so model-based problems run with
no MathWorks install.  Same here, against the port's own copies of the
emulation headers (``csrc/hxi_simulink/{simstruc.h, cg_sfun.h}``):

* ``build_sfunction(src, out=None)`` compiles a level-2 source with ``cc
  -O2 -shared -fPIC`` at ``out``, by default into
  ``build/hqp_tpu_torch_hxi/<hash>/`` (the layout, hashing and
  temporary-name-then-rename of :func:`hqp_tpu_torch.hxi.sfunction.cc_shared`;
  a failed build raises, nothing is written next to the source);
* :class:`SimulinkSFunction` drives it through the standard lifecycle
  (mdlInitializeSizes -> allocate -> mdlInitializeSampleTimes ->
  mdlInitializeConditions/mdlStart -> mdlOutputs/mdlUpdate/
  mdlDerivatives/mdlJacobian) via ctypes, on numpy buffers: a host model,
  which :class:`hqp_tpu_torch.omu.hosted.HostedModel` takes across the
  device boundary like the other hxi evaluators.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from hqp_tpu_torch.hxi.sfunction import CC_FLAGS, cc_shared, run_cc

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's SimStruct emulation (headers, MEX gateway, host library,
#: the demo S-function)
SIMULINK_DIR = os.path.join(_PKG, "csrc", "hxi_simulink")
#: the files a build against SIMULINK_DIR may include
_INCLUDES = ("simstruc.h", "cg_sfun.h", "simulink.c")

_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int)
_S = ctypes.c_void_p

#: the SimStruct accessors every emulated build exports (cg_sfun.h)
SS_SIGS = {
    "hxi_ss_create": (ctypes.c_void_p, []),
    "hxi_ss_set_param": (None, [_S, ctypes.c_int, _dp, ctypes.c_int,
                                ctypes.c_int]),
    "hxi_ss_allocate": (None, [_S]),
    "hxi_ss_destroy": (None, [_S]),
    "hxi_ss_ncont": (ctypes.c_int, [_S]),
    "hxi_ss_ndisc": (ctypes.c_int, [_S]),
    "hxi_ss_nin": (ctypes.c_int, [_S]),
    "hxi_ss_nout": (ctypes.c_int, [_S]),
    "hxi_ss_in_width": (ctypes.c_int, [_S, ctypes.c_int]),
    "hxi_ss_out_width": (ctypes.c_int, [_S, ctypes.c_int]),
    "hxi_ss_sample_time": (ctypes.c_double, [_S, ctypes.c_int]),
    "hxi_ss_error": (ctypes.c_char_p, [_S]),
    "hxi_ss_xc": (_dp, [_S]),
    "hxi_ss_dx": (_dp, [_S]),
    "hxi_ss_xd": (_dp, [_S]),
    "hxi_ss_u": (_dp, [_S, ctypes.c_int]),
    "hxi_ss_y": (_dp, [_S, ctypes.c_int]),
    "hxi_ss_set_t": (None, [_S, ctypes.c_double]),
    "hxi_ss_jac_nnz": (ctypes.c_int, [_S]),
    "hxi_ss_jac_ncols": (ctypes.c_int, [_S]),
    "hxi_ss_jac_pr": (_dp, [_S]),
    "hxi_ss_jac_ir": (_ip, [_S]),
    "hxi_ss_jac_jc": (_ip, [_S]),
}

#: the fixed-name method wrappers of a cg_sfun build
_CG_SIGS = {
    "hxi_mdlInitializeSizes": (None, [_S]),
    "hxi_mdlInitializeSampleTimes": (None, [_S]),
    "hxi_mdlInitializeConditions": (None, [_S]),
    "hxi_mdlStart": (None, [_S]),
    "hxi_mdlOutputs": (None, [_S, ctypes.c_int]),
    "hxi_mdlUpdate": (None, [_S, ctypes.c_int]),
    "hxi_mdlDerivatives": (None, [_S]),
    "hxi_mdlJacobian": (None, [_S]),
    "hxi_mdlTerminate": (None, [_S]),
    "hxi_has_update": (ctypes.c_int, []),
    "hxi_has_derivatives": (ctypes.c_int, []),
    "hxi_has_jacobian": (ctypes.c_int, []),
}


def bind(lib, sigs):
    """Set restype and argtypes of each function of ``sigs`` on ``lib``."""
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def build_emulated(src, name, defines=(), include_dir=None, out=None):
    """Compile ``src`` against the emulation headers (``include_dir``,
    default SIMULINK_DIR) into ``out`` if given, else into
    ``build/hqp_tpu_torch_hxi/<hash>/<name>``; the hash covers the source,
    the headers and the flags."""
    inc = include_dir or SIMULINK_DIR
    flags = [*defines, "-lm"]
    key = " ".join(flags).encode()
    for p in (src, *(os.path.join(inc, h) for h in _INCLUDES)):
        if os.path.isfile(p):
            with open(p, "rb") as fh:
                key += hashlib.sha256(fh.read()).digest()

    def write(tmp, out_dir):
        run_cc(["cc", *CC_FLAGS, *defines, "-I", inc, src, "-o", tmp,
                "-lm"])

    return cc_shared(name, write, key, out)


def build_sfunction(src: str, out: str | None = None,
                    include_dir: str | None = None) -> str:
    """Compile a level-2 C S-function source against the SimStruct
    emulation headers (the cg_sfun.h export shims), at ``out`` if given,
    else under ``build/``.  Returns the path of the built shared
    object."""
    name = os.path.splitext(os.path.basename(src))[0] + ".so"
    return build_emulated(src, name, include_dir=include_dir, out=out)


class EmulatedSFunction:
    """The driving surface shared by the cg_sfun and MEX hosts: the
    SimStruct lives in ``self._lib`` at ``self.S``; subclasses bind the
    method calls (``_outputs``, ``_update``, ``_derivatives``,
    ``_jacobian``)."""

    def _sizes(self):
        lib, S = self._lib, self.S
        self.ncont = lib.hxi_ss_ncont(S)
        self.ndisc = lib.hxi_ss_ndisc(S)
        self.nin = sum(lib.hxi_ss_in_width(S, p)
                       for p in range(lib.hxi_ss_nin(S)))
        self.nout = sum(lib.hxi_ss_out_width(S, p)
                        for p in range(lib.hxi_ss_nout(S)))

    def _check(self):
        err = self._lib.hxi_ss_error(self.S)
        if err:
            raise RuntimeError(f"{self._what} error: {err.decode()}")

    # -- buffer access -------------------------------------------------------

    def _view(self, ptr, n):
        if n == 0:
            return np.zeros(0)
        return np.ctypeslib.as_array(ptr, shape=(n,))

    @property
    def xd(self):
        return self._view(self._lib.hxi_ss_xd(self.S), self.ndisc)

    @property
    def xc(self):
        return self._view(self._lib.hxi_ss_xc(self.S), self.ncont)

    def sample_time(self, i=0):
        return float(self._lib.hxi_ss_sample_time(self.S, i))

    def set_inputs(self, u):
        u = np.asarray(u, np.float64).ravel()
        off = 0
        for p in range(self._lib.hxi_ss_nin(self.S)):
            w = self._lib.hxi_ss_in_width(self.S, p)
            buf = self._view(self._lib.hxi_ss_u(self.S, p), w)
            buf[:] = u[off:off + w]
            off += w

    # -- methods ---------------------------------------------------------------

    def outputs(self, t=0.0):
        self._lib.hxi_ss_set_t(self.S, t)
        self._outputs(self.S, 0)
        self._check()
        ys = []
        for p in range(self._lib.hxi_ss_nout(self.S)):
            w = self._lib.hxi_ss_out_width(self.S, p)
            ys.append(self._view(self._lib.hxi_ss_y(self.S, p), w).copy())
        return np.concatenate(ys) if ys else np.zeros(0)

    def update(self, t=0.0):
        self._lib.hxi_ss_set_t(self.S, t)
        self._update(self.S, 0)
        self._check()

    def derivatives(self, t=0.0):
        self._lib.hxi_ss_set_t(self.S, t)
        self._derivatives(self.S)
        self._check()
        return self._view(self._lib.hxi_ss_dx(self.S), self.ncont).copy()

    def jacobian(self):
        """Dense J = d(dxc, xd_next, y)/d(xc, xd, u) from the S-function's
        compressed-column mdlJacobian."""
        if not self.has_jacobian:
            raise RuntimeError(f"{self._what} provides no mdlJacobian")
        self._jacobian(self.S)
        lib = self._lib
        nnz = lib.hxi_ss_jac_nnz(self.S)
        ncols = lib.hxi_ss_jac_ncols(self.S)
        nrows = self.ncont + self.ndisc + self.nout
        pr = self._view(lib.hxi_ss_jac_pr(self.S), nnz)
        ir = np.ctypeslib.as_array(lib.hxi_ss_jac_ir(self.S), shape=(nnz,))
        jc = np.ctypeslib.as_array(lib.hxi_ss_jac_jc(self.S),
                                   shape=(ncols + 1,))
        J = np.zeros((nrows, ncols))
        for j in range(ncols):
            for k in range(jc[j], jc[j + 1]):
                J[ir[k], j] = pr[k]
        return J


class SimulinkSFunction(EmulatedSFunction):
    """A loaded level-2 S-function (a cg_sfun build) driven through the
    emulated API."""

    _what = "S-function"

    def __init__(self, so_path: str, params=()):
        lib = bind(ctypes.CDLL(so_path), {**SS_SIGS, **_CG_SIGS})
        self._lib = lib
        self._outputs = lib.hxi_mdlOutputs
        self._update = lib.hxi_mdlUpdate
        self._derivatives = lib.hxi_mdlDerivatives
        self._jacobian = lib.hxi_mdlJacobian

        self.S = lib.hxi_ss_create()
        self._params = [np.ascontiguousarray(np.atleast_1d(p), np.float64)
                        for p in params]
        for i, p in enumerate(self._params):
            lib.hxi_ss_set_param(self.S, i, p.ctypes.data_as(_dp), p.size, 1)
        lib.hxi_mdlInitializeSizes(self.S)
        self._check()
        lib.hxi_ss_allocate(self.S)
        lib.hxi_mdlInitializeSampleTimes(self.S)
        lib.hxi_mdlInitializeConditions(self.S)
        lib.hxi_mdlStart(self.S)
        self._check()

        self._sizes()
        self.has_update = bool(lib.hxi_has_update())
        self.has_derivatives = bool(lib.hxi_has_derivatives())
        self.has_jacobian = bool(lib.hxi_has_jacobian())

    def terminate(self):
        if not getattr(self, "_terminated", False):
            self._lib.hxi_mdlTerminate(self.S)
            self._terminated = True

    def __del__(self):
        # release model resources (mdlStart/PWork allocations) before
        # freeing the SimStruct, as the reference's emulation does on
        # destruction (hxi/Hxi_SimStruct.C)
        try:
            self.terminate()
            self._lib.hxi_ss_destroy(self.S)
        except Exception:
            pass
