"""FMI 2.0 model-exchange FMU hosting.

Port of ``hqp_tpu/hxi/fmu.py`` (host ctypes and numpy, unchanged but for
where files go).  Role of the reference's FMU wrapper (hxi/sfun_fmu.c
presenting an FMU as an S-function; hxi/fmi.tcl doing the unzip /
modelDescription.xml parsing / variable mapping, procs extractModel:71,
readModelDescription:111, getModelVariables:400, unzip:642).  Here the
Tcl side is Python (zipfile + xml.etree) and the C API binding is ctypes;
the loaded FMU exposes the same evaluator interface as
:class:`hqp_tpu_torch.hxi.sfunction.SFunction` so the hosted-model bridge
treats all external models alike.

``build_test_fmu`` generates a complete little FMU (model description +
compiled fmi2 C implementation of a double integrator) so the whole path
is testable hermetically -- the role of the reference's odc FMU test
scripts (odc/dic_fmu_est.tcl) without shipping binaries.  The FMU is
built into ``build/hqp_tpu_torch_hxi/<hash>/`` (as the S-functions are),
and each loaded FMU is unpacked into a fresh directory under
``build/hqp_tpu_torch_hxi/fmu/``, so parallel processes never share a
file.
"""

from __future__ import annotations

import ctypes
import os
import platform
import tempfile
import xml.etree.ElementTree as ET
import zipfile

import numpy as np

from hqp_tpu_torch.hxi.sfunction import (BUILD_ROOT, CC_FLAGS, cc_shared,
                                         run_cc)

fmi2OK = 0


def _binary_subdir():
    mach = platform.machine().lower()
    if mach in ("x86_64", "amd64"):
        return "linux64"
    if mach in ("aarch64", "arm64"):
        return "aarch64-linux"
    return "linux64"


class _Fmi2Callbacks(ctypes.Structure):
    _fields_ = [
        ("logger", ctypes.c_void_p),
        ("allocateMemory", ctypes.c_void_p),
        ("freeMemory", ctypes.c_void_p),
        ("stepFinished", ctypes.c_void_p),
        ("componentEnvironment", ctypes.c_void_p),
    ]


_ALLOC_T = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.c_size_t)
_FREE_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_LOG_T = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p,
                          ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)

_libc = ctypes.CDLL(None)
_libc.calloc.restype = ctypes.c_void_p
_libc.calloc.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
_libc.free.argtypes = [ctypes.c_void_p]

_alloc_cb = _ALLOC_T(lambda n, sz: _libc.calloc(n, sz))
_free_cb = _FREE_T(lambda p: _libc.free(p))
_log_cb = _LOG_T(lambda env, name, status, cat, msg: None)


class FmuVariable:
    """One ScalarVariable of the model description."""

    def __init__(self, name, vr, causality, variability, start,
                 derivative_of=None):
        self.name = name
        self.vr = vr
        self.causality = causality
        self.variability = variability
        self.start = start
        self.derivative_of = derivative_of  # index of state variable

    def __repr__(self):
        return (f"FmuVariable({self.name!r}, vr={self.vr}, "
                f"causality={self.causality!r})")


class Fmu:
    """A loaded FMI 2.0 model-exchange FMU.

    Evaluator interface: nx/nu/ny sizes, ``derivatives(t, x, u)``,
    ``outputs(t, x, u)``; plus parameter setting by variable name and
    analytic ``jacobian`` via fmi2GetDirectionalDerivative when the FMU
    provides it.
    """

    def __init__(self, path: str, params: dict | None = None):
        self.path = path
        root = os.path.join(BUILD_ROOT, "fmu")
        os.makedirs(root, exist_ok=True)
        self._dir = tempfile.mkdtemp(prefix="hqp_fmu_", dir=root)
        with zipfile.ZipFile(path) as z:          # fmi.tcl unzip:642
            z.extractall(self._dir)
        self._parse_description()
        self._load_binary()
        self._instantiate(params or {})

    # -- model description (fmi.tcl readModelDescription) -------------------
    def _parse_description(self):
        tree = ET.parse(os.path.join(self._dir, "modelDescription.xml"))
        root = tree.getroot()
        self.model_name = self.name = root.get("modelName")
        self.guid = root.get("guid")
        me = root.find("ModelExchange")
        if me is None:
            raise ValueError("FMU has no ModelExchange section")
        self.model_identifier = me.get("modelIdentifier")
        self.provides_directional = (
            me.get("providesDirectionalDerivative") == "true")

        self.variables = []
        for i, sv in enumerate(root.find("ModelVariables")):
            if sv.tag != "ScalarVariable":
                continue
            real = sv.find("Real")
            if real is None:
                continue
            der = real.get("derivative")
            self.variables.append(FmuVariable(
                name=sv.get("name"),
                vr=int(sv.get("valueReference")),
                causality=sv.get("causality", "local"),
                variability=sv.get("variability", "continuous"),
                start=(float(real.get("start"))
                       if real.get("start") is not None else None),
                derivative_of=(int(der) - 1 if der is not None else None),
            ))

        # states = variables some derivative points at (fmi.tcl's
        # derivative-based state detection)
        der_vars = [v for v in self.variables
                    if v.derivative_of is not None]
        self._state_vars = [self.variables[v.derivative_of]
                            for v in der_vars]
        self._der_vars = der_vars
        self._input_vars = [v for v in self.variables
                            if v.causality == "input"]
        self._output_vars = [v for v in self.variables
                             if v.causality == "output"]
        self._param_vars = {v.name: v for v in self.variables
                            if v.causality == "parameter"}
        self.nx = len(self._state_vars)
        self.nxd = 0
        self.nu = len(self._input_vars)
        self.ny = len(self._output_vars)

    # -- binary ---------------------------------------------------------------
    def _load_binary(self):
        sub = _binary_subdir()
        so = os.path.join(self._dir, "binaries", sub,
                          self.model_identifier + ".so")
        if not os.path.exists(so):
            bindir = os.path.join(self._dir, "binaries")
            cands = []
            for d, _, files in os.walk(bindir):
                cands += [os.path.join(d, f) for f in files
                          if f.endswith(".so")]
            if not cands:
                raise FileNotFoundError(
                    f"no linux binary in FMU {self.path}")
            so = cands[0]
        lib = ctypes.CDLL(so)
        vrp = ctypes.POINTER(ctypes.c_uint)
        dp = ctypes.POINTER(ctypes.c_double)
        c = ctypes.c_void_p
        sigs = {
            "fmi2Instantiate": (c, [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.POINTER(_Fmi2Callbacks),
                                    ctypes.c_int, ctypes.c_int]),
            "fmi2SetupExperiment": (ctypes.c_int, [c, ctypes.c_int,
                                                   ctypes.c_double,
                                                   ctypes.c_double,
                                                   ctypes.c_int,
                                                   ctypes.c_double]),
            "fmi2EnterInitializationMode": (ctypes.c_int, [c]),
            "fmi2ExitInitializationMode": (ctypes.c_int, [c]),
            "fmi2EnterContinuousTimeMode": (ctypes.c_int, [c]),
            "fmi2SetTime": (ctypes.c_int, [c, ctypes.c_double]),
            "fmi2SetContinuousStates": (ctypes.c_int, [c, dp,
                                                       ctypes.c_size_t]),
            "fmi2GetDerivatives": (ctypes.c_int, [c, dp, ctypes.c_size_t]),
            "fmi2GetContinuousStates": (ctypes.c_int, [c, dp,
                                                       ctypes.c_size_t]),
            "fmi2SetReal": (ctypes.c_int, [c, vrp, ctypes.c_size_t, dp]),
            "fmi2GetReal": (ctypes.c_int, [c, vrp, ctypes.c_size_t, dp]),
            "fmi2FreeInstance": (None, [c]),
            "fmi2Terminate": (ctypes.c_int, [c]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        if self.provides_directional:
            fn = lib.fmi2GetDirectionalDerivative
            fn.restype = ctypes.c_int
            fn.argtypes = [c, vrp, ctypes.c_size_t, vrp, ctypes.c_size_t,
                           dp, dp]
        self._lib = lib

    def _instantiate(self, params: dict):
        cb = _Fmi2Callbacks(
            logger=ctypes.cast(_log_cb, ctypes.c_void_p),
            allocateMemory=ctypes.cast(_alloc_cb, ctypes.c_void_p),
            freeMemory=ctypes.cast(_free_cb, ctypes.c_void_p),
            stepFinished=None, componentEnvironment=None)
        self._cb = cb  # keep alive
        comp = self._lib.fmi2Instantiate(
            self.model_name.encode(), 0,  # fmi2ModelExchange
            self.guid.encode(),
            ("file://" + os.path.join(self._dir, "resources")).encode(),
            ctypes.byref(cb), 0, 0)
        if not comp:
            raise RuntimeError("fmi2Instantiate failed")
        self._comp = comp
        self._ok(self._lib.fmi2SetupExperiment(comp, 0, 0.0, 0.0, 0, 0.0))
        self._ok(self._lib.fmi2EnterInitializationMode(comp))
        if params:
            self.set_params(params)
        self._ok(self._lib.fmi2ExitInitializationMode(comp))
        self._ok(self._lib.fmi2EnterContinuousTimeMode(comp))

        # start values
        self.x0 = np.array([v.start if v.start is not None else 0.0
                            for v in self._state_vars])

    def _ok(self, status):
        if status not in (fmi2OK, 1):  # OK or Warning
            raise RuntimeError(f"FMI call failed with status {status}")

    def _set_reals(self, vrs, vals):
        n = len(vrs)
        vr_arr = (ctypes.c_uint * n)(*vrs)
        v_arr = (ctypes.c_double * n)(*[float(v) for v in vals])
        self._ok(self._lib.fmi2SetReal(self._comp, vr_arr, n, v_arr))

    def _get_reals(self, vrs):
        n = len(vrs)
        vr_arr = (ctypes.c_uint * n)(*vrs)
        v_arr = (ctypes.c_double * n)()
        self._ok(self._lib.fmi2GetReal(self._comp, vr_arr, n, v_arr))
        return np.array(v_arr[:])

    def set_params(self, params: dict):
        vrs, vals = [], []
        for name, val in params.items():
            if name not in self._param_vars:
                raise KeyError(f"FMU has no parameter {name!r}")
            vrs.append(self._param_vars[name].vr)
            vals.append(val)
        if vrs:
            self._set_reals(vrs, vals)

    # -- evaluation -----------------------------------------------------------
    def _set_txu(self, t, x, u):
        self._ok(self._lib.fmi2SetTime(self._comp, float(t)))
        if self.nx:
            arr = (ctypes.c_double * self.nx)(*[float(v) for v in x])
            self._ok(self._lib.fmi2SetContinuousStates(
                self._comp, arr, self.nx))
        if self.nu:
            self._set_reals([v.vr for v in self._input_vars], u)

    def derivatives(self, t, x, u):
        self._set_txu(t, x, u)
        dx = (ctypes.c_double * self.nx)()
        self._ok(self._lib.fmi2GetDerivatives(self._comp, dx, self.nx))
        return np.array(dx[:])

    def outputs(self, t, x, u):
        self._set_txu(t, x, u)
        return self._get_reals([v.vr for v in self._output_vars])

    def jacobian(self, t, x, u):
        """Analytic [dfdx | dfdu] via fmi2GetDirectionalDerivative
        (the reference's mdl_jac path, omu/Omu_Model.C setup_jac), or
        None when the FMU does not provide it."""
        if not self.provides_directional:
            return None
        self._set_txu(t, x, u)
        unknowns = [v.vr for v in self._der_vars]
        knowns = ([v.vr for v in self._state_vars]
                  + [v.vr for v in self._input_vars])
        nk = len(knowns)
        J = np.zeros((self.nx, nk))
        u_arr = (ctypes.c_uint * self.nx)(*unknowns)
        k_arr = (ctypes.c_uint * nk)(*knowns)
        dv = (ctypes.c_double * nk)()
        out = (ctypes.c_double * self.nx)()
        for j in range(nk):
            for i in range(nk):
                dv[i] = 1.0 if i == j else 0.0
            self._ok(self._lib.fmi2GetDirectionalDerivative(
                self._comp, u_arr, self.nx, k_arr, nk, dv, out))
            J[:, j] = out[:]
        return J

    def terminate(self):
        if getattr(self, "_comp", None):
            self._lib.fmi2Terminate(self._comp)
            self._lib.fmi2FreeInstance(self._comp)
            self._comp = None


# ---------------------------------------------------------------------------
# the hermetic test FMU
# ---------------------------------------------------------------------------

_TEST_FMU_C = r"""
/* generated: minimal fmi2 model-exchange implementation of a double
 * integrator with states (v, s) -- hqp_docp/Prg_DID.C state order --
 * dv=u/m, ds=v, parameter m. */
#include <stdlib.h>
#include <string.h>

#define VR_V 0
#define VR_S 1
#define VR_DV 2
#define VR_DS 3
#define VR_U 4
#define VR_M 5
#define VR_YV 6
#define VR_YS 7
#define NVALS 8

typedef struct { double vals[NVALS]; double t; } Comp;

typedef void* fmi2Component;

const char* fmi2GetVersion(void) { return "2.0"; }
const char* fmi2GetTypesPlatform(void) { return "default"; }

fmi2Component fmi2Instantiate(const char* name, int type,
    const char* guid, const char* loc, const void* cb, int vis, int log) {
    Comp* c = (Comp*)calloc(1, sizeof(Comp));
    c->vals[VR_M] = 1.0;
    (void)name; (void)type; (void)guid; (void)loc; (void)cb;
    (void)vis; (void)log;
    return c;
}
void fmi2FreeInstance(fmi2Component c) { free(c); }
int fmi2SetupExperiment(fmi2Component c, int tolDef, double tol,
    double t0, int stopDef, double tStop) {
    ((Comp*)c)->t = t0;
    (void)tolDef; (void)tol; (void)stopDef; (void)tStop; return 0;
}
int fmi2EnterInitializationMode(fmi2Component c) { (void)c; return 0; }
int fmi2ExitInitializationMode(fmi2Component c) { (void)c; return 0; }
int fmi2EnterContinuousTimeMode(fmi2Component c) { (void)c; return 0; }
int fmi2EnterEventMode(fmi2Component c) { (void)c; return 0; }
int fmi2Terminate(fmi2Component c) { (void)c; return 0; }
int fmi2Reset(fmi2Component c) { (void)c; return 0; }
int fmi2SetTime(fmi2Component c, double t) { ((Comp*)c)->t = t; return 0; }

static void refresh(Comp* c) {
    c->vals[VR_DS] = c->vals[VR_V];
    c->vals[VR_DV] = c->vals[VR_U] / c->vals[VR_M];
    c->vals[VR_YV] = c->vals[VR_V];
    c->vals[VR_YS] = c->vals[VR_S];
}
int fmi2SetContinuousStates(fmi2Component cc, const double* x, size_t n) {
    Comp* c = (Comp*)cc;
    if (n > 0) c->vals[VR_V] = x[0];
    if (n > 1) c->vals[VR_S] = x[1];
    refresh(c); return 0;
}
int fmi2GetContinuousStates(fmi2Component cc, double* x, size_t n) {
    Comp* c = (Comp*)cc;
    if (n > 0) x[0] = c->vals[VR_V];
    if (n > 1) x[1] = c->vals[VR_S];
    return 0;
}
int fmi2GetDerivatives(fmi2Component cc, double* dx, size_t n) {
    Comp* c = (Comp*)cc; refresh(c);
    if (n > 0) dx[0] = c->vals[VR_DV];
    if (n > 1) dx[1] = c->vals[VR_DS];
    return 0;
}
int fmi2SetReal(fmi2Component cc, const unsigned* vr, size_t n,
                const double* v) {
    Comp* c = (Comp*)cc; size_t i;
    for (i = 0; i < n; i++) if (vr[i] < NVALS) c->vals[vr[i]] = v[i];
    refresh(c); return 0;
}
int fmi2GetReal(fmi2Component cc, const unsigned* vr, size_t n, double* v) {
    Comp* c = (Comp*)cc; size_t i; refresh(c);
    for (i = 0; i < n; i++) v[i] = (vr[i] < NVALS) ? c->vals[vr[i]] : 0.0;
    return 0;
}
int fmi2GetDirectionalDerivative(fmi2Component cc,
    const unsigned* unk, size_t nu_, const unsigned* kn, size_t nk,
    const double* dv, double* out) {
    Comp* c = (Comp*)cc; size_t i, j;
    for (i = 0; i < nu_; i++) {
        double acc = 0.0;
        for (j = 0; j < nk; j++) {
            double d = 0.0;
            if (unk[i] == VR_DS && kn[j] == VR_V) d = 1.0;
            if (unk[i] == VR_DV && kn[j] == VR_U) d = 1.0 / c->vals[VR_M];
            acc += d * dv[j];
        }
        out[i] = acc;
    }
    return 0;
}
"""

_TEST_FMU_XML = """<?xml version="1.0" encoding="UTF-8"?>
<fmiModelDescription fmiVersion="2.0" modelName="dic"
  guid="{{hqp-tpu-test-dic}}" numberOfEventIndicators="0">
  <ModelExchange modelIdentifier="dic"
    providesDirectionalDerivative="true"/>
  <ModelVariables>
    <ScalarVariable name="v" valueReference="0" causality="local"
      variability="continuous" initial="exact">
      <Real start="0.0"/></ScalarVariable>
    <ScalarVariable name="s" valueReference="1" causality="local"
      variability="continuous" initial="exact">
      <Real start="0.0"/></ScalarVariable>
    <ScalarVariable name="der(v)" valueReference="2" causality="local"
      variability="continuous"><Real derivative="1"/></ScalarVariable>
    <ScalarVariable name="der(s)" valueReference="3" causality="local"
      variability="continuous"><Real derivative="2"/></ScalarVariable>
    <ScalarVariable name="u" valueReference="4" causality="input"
      variability="continuous"><Real start="0.0"/></ScalarVariable>
    <ScalarVariable name="m" valueReference="5" causality="parameter"
      variability="fixed"><Real start="1.0"/></ScalarVariable>
    <ScalarVariable name="y_v" valueReference="6" causality="output"
      variability="continuous"><Real/></ScalarVariable>
    <ScalarVariable name="y_s" valueReference="7" causality="output"
      variability="continuous"><Real/></ScalarVariable>
  </ModelVariables>
  <ModelStructure>
    <Derivatives>
      <Unknown index="3"/><Unknown index="4"/>
    </Derivatives>
  </ModelStructure>
</fmiModelDescription>
"""


def build_test_fmu(out_path: str | None = None) -> str:
    """Build the double-integrator test FMU (compile + zip) at
    ``out_path`` if given, else into
    ``build/hqp_tpu_torch_hxi/<hash>/hqp_tpu_dic.fmu``; returns its path.

    Gives the FMU path hermetic test coverage, mirroring the role of the
    reference's FMU examples without shipping binaries.
    """
    def write(tmp, out_dir):
        with tempfile.TemporaryDirectory(dir=out_dir) as d:
            src = os.path.join(d, "dic.c")
            with open(src, "w") as f:
                f.write(_TEST_FMU_C)
            so = os.path.join(d, "dic.so")
            run_cc(["cc", *CC_FLAGS, src, "-o", so])
            with zipfile.ZipFile(tmp, "w") as z:
                z.writestr("modelDescription.xml", _TEST_FMU_XML)
                z.write(so, f"binaries/{_binary_subdir()}/dic.so")

    key = (_TEST_FMU_C + _TEST_FMU_XML + _binary_subdir()).encode()
    return cc_shared("hqp_tpu_dic.fmu", write, key, out_path)
