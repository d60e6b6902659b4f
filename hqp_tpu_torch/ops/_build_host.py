"""Build the port's host library (the sparse LDL'/BKP kernels).

``csrc/host/sparse_ldl.cpp`` is compiled by ``g++`` with the JAX
package's flags into ``build/hqp_tpu_torch_host/<hash>/`` beside the
package (``.gitignore`` lists ``build/``) at the first use, on a CPU host
and on the card's host alike; the hash covers the source and the flags.
The library is written to a temporary name and renamed, so concurrent
first uses (test workers) never load a half-written file.  A failed build
raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "sparse_ldl.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "hqp_tpu_torch_host")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

#: set by the first build: {"path", "seconds", "built"}
INFO: dict = {}


def build():
    """Compile the library if this source hash has none yet; returns its
    path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib = os.path.join(out_dir, "libhqpsparse.so")
    if os.path.isfile(lib):
        INFO.update(path=lib, seconds=0.0, built=False)
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = ["g++", *CXX_FLAGS, SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    INFO.update(path=lib, seconds=time.perf_counter() - t0, built=True)
    return lib
