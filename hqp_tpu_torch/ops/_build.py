"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into ONE shared library with a plain C interface, which is loaded with
ctypes.  The build happens at the first CUDA use, from the sources in the
checkout alone, into ``build/hqp_tpu_torch/<hash>/`` beside the package
(``.gitignore`` lists ``build/``); the hash covers the sources and the
flags, so an edited kernel rebuilds and an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "hqp_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points and their argument types (pointers and the stream are
#: c_void_p so ctypes passes them at full width)
SIGNATURES = {
    "hqp_gj_interior_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_gj_interior_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_gj_interior_smem_f64": [_I, _I],
    "hqp_gj_interior_smem_f32": [_I, _I],
    "hqp_gj_interior_attrs_f64": [_I, _I, _P],
    "hqp_gj_interior_attrs_f32": [_I, _I, _P],
    "hqp_gj_batch_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_gj_batch_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_gj_batch_smem_f64": [_I, _I],
    "hqp_gj_batch_smem_f32": [_I, _I],
    "hqp_gj_batch_attrs_f64": [_I, _I, _P],
    "hqp_gj_batch_attrs_f32": [_I, _I, _P],
    "hqp_gj_large_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hqp_gj_large_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hqp_gj_large_smem_f64": [_I, _I, _I],
    "hqp_gj_large_smem_f32": [_I, _I, _I],
    "hqp_thomas_f64": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_thomas_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hqp_thomas_plan_f64": [_I, _I],
    "hqp_thomas_plan_f32": [_I, _I],
}
_RESTYPES = {"hqp_gj_interior_smem_f64": ctypes.c_size_t,
             "hqp_gj_interior_smem_f32": ctypes.c_size_t,
             "hqp_gj_batch_smem_f64": ctypes.c_size_t,
             "hqp_gj_batch_smem_f32": ctypes.c_size_t,
             "hqp_gj_large_smem_f64": ctypes.c_size_t,
             "hqp_gj_large_smem_f32": ctypes.c_size_t}

#: set by the first build: {"path", "seconds", "log", "built"}
INFO: dict = {}
_LIB = None


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def nvcc_path():
    """nvcc from CUDA_HOME, PATH or /usr/local/cuda; raises if missing."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(srcs):
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in srcs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this source hash has no library yet; returns
    the library path.  The build writes to a temporary name and renames, so
    concurrent first uses never load a half-written file."""
    srcs = [p for p in sources() if p.endswith(".cu")]
    out_dir = os.path.join(BUILD_ROOT, _digest(sources()))
    lib = os.path.join(out_dir, "libhqp_tpu_torch.so")
    if os.path.isfile(lib):
        INFO.update(path=lib, seconds=0.0, log="", built=False)
        return lib
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = os.path.join(work, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for cmd, _, proc in jobs:
        log += " ".join(cmd) + "\n" + proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if not failed:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(proc.returncode)
    shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    os.replace(tmp, lib)
    with open(os.path.join(out_dir, "nvcc.log"), "w") as fh:
        fh.write(log)
    INFO.update(path=lib, seconds=secs, log=log, built=True)
    return lib


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _LIB = lib
    return _LIB


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
