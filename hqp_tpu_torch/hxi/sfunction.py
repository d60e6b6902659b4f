"""Binary S-function loading.

Port of ``hqp_tpu/hxi/sfunction.py`` (reference: hxi/Hxi_SFunction.{h,C}):
dlopen a compiled S-function shared library and drive its mdl* callbacks.
The C ABI is defined by the port's own copies of the headers,
``csrc/hxi/hxi_sfun.h`` (a ctypes-friendly SimStruct struct) and
``csrc/hxi/hxi_sfun_exports.h`` (fixed-name exported wrappers
hxi_mdlInitializeSizes/...).  :func:`compile_sfunction` builds a .c model
source against those headers with ``cc -O2 -shared -fPIC`` into
``build/hqp_tpu_torch_hxi/<hash>/`` beside the package (``.gitignore``
lists ``build/``), so the demo models ``csrc/hxi/sfun_did.c`` and
``sfun_dic.c`` (the roles of odc/sfun_did.c, odc/sfun_dic.c) need no
prebuilt binary.  The hash covers the sources, the headers and the flags;
each library is written to a temporary name and renamed, so concurrent
first uses never load a half-written file; a failed build raises.  The
build never writes next to the source.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np

HXI_MAX_PARAMS = 16
HXI_ERRMSG_LEN = 256

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's S-function headers and demo models
HXI_DIR = os.path.join(_PKG, "csrc", "hxi")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "hqp_tpu_torch_hxi")
CC_FLAGS = ["-O2", "-shared", "-fPIC"]
_HEADERS = [os.path.join(HXI_DIR, h)
            for h in ("hxi_sfun.h", "hxi_sfun_exports.h")]

#: each build by file name: {"path", "seconds", "built"}
INFO: dict = {}

_dp = ctypes.POINTER(ctypes.c_double)


def cc_shared(name, write, key: bytes, out: str | None = None):
    """``build/hqp_tpu_torch_hxi/<hash of key and CC_FLAGS>/<name>``, made
    by ``write(tmp_path, out_dir)`` if this hash has none yet (``write``
    fills the temporary file, which is then renamed into place).  With
    ``out`` the file is built there instead, every time."""
    if out is None:
        h = hashlib.sha256(" ".join(CC_FLAGS).encode() + key)
        out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
        out = os.path.join(out_dir, name)
        if os.path.isfile(out):
            INFO[name] = dict(path=out, seconds=0.0, built=False)
            return out
    else:
        out = os.path.abspath(out)
        out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(name)[1],
                               dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        write(tmp, out_dir)
    except BaseException:
        os.unlink(tmp)
        raise
    os.replace(tmp, out)
    INFO[name] = dict(path=out, seconds=time.perf_counter() - t0,
                      built=True)
    return out


def run_cc(cmd):
    """Run a compiler command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")


def compile_sfunction(src: str, out: str | None = None) -> str:
    """Compile an S-function .c source against the port's hxi headers to a
    shared library, at ``out`` if given, else under ``build/``; returns
    the .so path."""
    key = b""
    for p in (src, *_HEADERS):
        with open(p, "rb") as fh:
            key += hashlib.sha256(fh.read()).digest()

    def write(tmp, out_dir):
        run_cc(["cc", *CC_FLAGS, "-I", HXI_DIR, src, "-o", tmp])

    name = os.path.splitext(os.path.basename(src))[0] + ".so"
    return cc_shared(name, write, key, out)


def demo_sfunction_path(name: str) -> str:
    """Path of a demo S-function ('sfun_did' or 'sfun_dic'), compiled on
    demand."""
    return compile_sfunction(os.path.join(HXI_DIR, name + ".c"))


class _CSimStruct(ctypes.Structure):
    """ctypes mirror of csrc/hxi/hxi_sfun.h struct HxiSimStruct."""

    _fields_ = [
        ("nx", ctypes.c_int),
        ("nxd", ctypes.c_int),
        ("nu", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("np", ctypes.c_int),
        ("np_set", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("t", ctypes.c_double),
        ("sample_time", ctypes.c_double),
        ("x", _dp),
        ("dx", _dp),
        ("xd", _dp),
        ("u", _dp),
        ("y", _dp),
        ("p", _dp * HXI_MAX_PARAMS),
        ("p_len", ctypes.c_int * HXI_MAX_PARAMS),
        ("errmsg", ctypes.c_char * HXI_ERRMSG_LEN),
    ]


class SFunction:
    """A loaded binary S-function instance.

    Evaluator interface (shared with PySFunctionHost): sizes as
    attributes, plus derivatives/outputs/update methods operating on
    numpy arrays.  Each instance owns a private SimStruct, so multiple
    instances of one library evaluate independently (the role of the
    per-thread SimStruct copies in omu/Omu_Model.h:55).
    """

    _CAP = 1024

    def __init__(self, path: str, params=()):
        if path.endswith(".c"):
            path = compile_sfunction(path)
        self.path = path
        self.name = os.path.splitext(os.path.basename(path))[0]
        self._lib = ctypes.CDLL(path)
        for fn in ("hxi_mdlInitializeSizes", "hxi_mdlStart",
                   "hxi_mdlInitializeConditions", "hxi_mdlDerivatives",
                   "hxi_mdlOutputs", "hxi_mdlUpdate", "hxi_mdlTerminate"):
            getattr(self._lib, fn).argtypes = [ctypes.POINTER(_CSimStruct)]
            getattr(self._lib, fn).restype = ctypes.c_int

        self.S = _CSimStruct()
        cap = self._CAP
        self._bufs = {n: np.zeros(cap) for n in ("x", "dx", "xd", "u", "y")}
        for n, b in self._bufs.items():
            setattr(self.S, n, b.ctypes.data_as(_dp))
        self.S.cap = cap

        params = [np.atleast_1d(np.asarray(p, np.float64)).copy()
                  for p in params]
        if len(params) > HXI_MAX_PARAMS:
            raise ValueError("too many S-function parameters")
        self._params = params
        self.S.np_set = len(params)
        for i, p in enumerate(params):
            self.S.p[i] = p.ctypes.data_as(_dp)
            self.S.p_len[i] = p.size

        self._check("hxi_mdlInitializeSizes")
        if max(self.S.nx, self.S.nxd, self.S.nu, self.S.ny) > cap:
            raise ValueError("model sizes exceed host buffer capacity")
        self._check("hxi_mdlInitializeSampleTimes", optional=True)
        self._check("hxi_mdlStart")
        self._check("hxi_mdlInitializeConditions")

    def _check(self, fn, optional=False):
        f = getattr(self._lib, fn, None)
        if f is None:
            if optional:
                return
            raise AttributeError(fn)
        if f(ctypes.byref(self.S)) != 0:
            raise RuntimeError(
                f"{fn}: {self.S.errmsg.decode(errors='replace')}")

    # -- sizes ----------------------------------------------------------------
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

    @property
    def sample_time(self):
        return self.S.sample_time

    # -- evaluation: every call sets all of its inputs --------------------------
    def derivatives(self, t, x, u):
        S = self.S
        S.t = float(t)
        self._bufs["x"][: S.nx] = x
        self._bufs["u"][: S.nu] = u
        self._bufs["dx"][: S.nx] = 0.0
        self._check("hxi_mdlDerivatives")
        return self._bufs["dx"][: S.nx].copy()

    def outputs(self, t, x, u):
        S = self.S
        S.t = float(t)
        if S.nx:
            self._bufs["x"][: S.nx] = x
        else:
            self._bufs["xd"][: S.nxd] = x
        self._bufs["u"][: S.nu] = u
        self._bufs["y"][: S.ny] = 0.0
        self._check("hxi_mdlOutputs")
        return self._bufs["y"][: S.ny].copy()

    def update(self, t, xd, u):
        S = self.S
        S.t = float(t)
        self._bufs["xd"][: S.nxd] = xd
        self._bufs["u"][: S.nu] = u
        self._check("hxi_mdlUpdate")
        return self._bufs["xd"][: S.nxd].copy()

    def terminate(self):
        self._check("hxi_mdlTerminate")
