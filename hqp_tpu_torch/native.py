"""ctypes binding of the port's host sparse kernels.

Port of ``hqp_tpu/native/__init__.py``: reverse Cuthill-McKee ordering
(role of hqp/sprcm.C), the sparse LDL' of a quasidefinite matrix with its
diagonal safeguard (spMODCHOLfac role) and the sparse Bunch-Kaufman-Parlett
factorization of a symmetric indefinite matrix (spBKP.C role).  The
library is the port's own build of ``csrc/host/sparse_ldl.cpp``
(:mod:`hqp_tpu_torch.ops._build_host`), made at the first call.  All
arguments and results are numpy arrays on the host: these factorizations
run on the CPU in both packages.

Beyond the reference: :attr:`SparseLDL.n_floored` and
:attr:`SparseBKP.n_pinned` count the pivots that the last factorization
floored at ``reg`` or pinned to 1.0.
"""

from __future__ import annotations

import ctypes

import numpy as np

from hqp_tpu_torch.ops import _build_host

_IP = ctypes.POINTER(ctypes.c_int)
_DP = ctypes.POINTER(ctypes.c_double)
_H = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: C entry points: (argument types, result type)
SIGNATURES = {
    "hqp_rcm_order": ([_I, _IP, _IP, _IP], None),
    "hqp_ldl_create": ([_I, _IP, _IP], _H),
    "hqp_ldl_factor": ([_H, _IP, _IP, _DP, _D], _I),
    "hqp_ldl_solve": ([_H, _DP], None),
    "hqp_ldl_nnz": ([_H], _I),
    "hqp_ldl_nfloored": ([_H], _I),
    "hqp_ldl_destroy": ([_H], None),
    "hqp_bkp_factor": ([_I, _IP, _IP, _DP, _D, _D], _H),
    "hqp_bkp_solve": ([_H, _DP], None),
    "hqp_bkp_nnz": ([_H], _I),
    "hqp_bkp_n2x2": ([_H], _I),
    "hqp_bkp_npinned": ([_H], _I),
    "hqp_bkp_destroy": ([_H], None),
}

_LIB = None


def library():
    """The loaded host library (built on the first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_host.build())
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = lib
    return _LIB


def _ci(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _cd(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _csr(n, rowptr, colind, values=None):
    """Contiguous int32 / float64 copies of a CSR matrix of order n, checked
    before the C code reads them through raw pointers."""
    rowptr, colind = _ci(rowptr), _ci(colind)
    if rowptr.shape != (n + 1,) or rowptr[0] != 0 or \
            colind.shape != (rowptr[-1],) or np.any(np.diff(rowptr) < 0):
        raise ValueError(f"not a CSR pattern of order {n}")
    if colind.size and (colind.min() < 0 or colind.max() >= n):
        raise ValueError(f"CSR column index outside [0, {n})")
    if values is None:
        return rowptr, colind
    values = _cd(values)
    if values.shape != colind.shape:
        raise ValueError(f"{values.shape[0]} CSR values for "
                         f"{colind.shape[0]} entries")
    return rowptr, colind, values


def _solve_columns(fn, h, n, b):
    """x = A^-1 b through the in-place C solve, column by column."""
    x = np.array(b, dtype=np.float64, copy=True)
    if x.shape[0] != n or x.ndim > 2:
        raise ValueError(f"right-hand side of shape {x.shape} for order {n}")
    if x.ndim == 1:
        fn(h, x.ctypes.data_as(_DP))
        return x
    for j in range(x.shape[1]):
        col = np.ascontiguousarray(x[:, j])
        fn(h, col.ctypes.data_as(_DP))
        x[:, j] = col
    return x


def rcm_order(n, rowptr, colind):
    """Reverse Cuthill-McKee permutation of a symmetric CSR pattern (both
    triangles): perm[k] is the original index of the k-th node."""
    rowptr, colind = _csr(n, rowptr, colind)
    perm = np.zeros(n, dtype=np.int32)
    library().hqp_rcm_order(n, rowptr.ctypes.data_as(_IP),
                            colind.ctypes.data_as(_IP),
                            perm.ctypes.data_as(_IP))
    return perm


class SparseLDL:
    """Sparse LDL' of a symmetric quasidefinite matrix in full CSR form:
    the symbolic analysis (elimination tree) at construction, a numeric
    factorization per :meth:`factor` with |D_k| floored at ``reg``."""

    def __init__(self, n, rowptr, colind):
        self.n = n
        self.rowptr, self.colind = _csr(n, rowptr, colind)
        self._lib = library()
        self._h = self._lib.hqp_ldl_create(
            n, self.rowptr.ctypes.data_as(_IP),
            self.colind.ctypes.data_as(_IP))
        if not self._h:
            raise MemoryError("sparse LDL: allocation failure")

    def factor(self, values, reg=0.0):
        _, _, vals = _csr(self.n, self.rowptr, self.colind, values)
        rc = self._lib.hqp_ldl_factor(
            self._h, self.rowptr.ctypes.data_as(_IP),
            self.colind.ctypes.data_as(_IP), vals.ctypes.data_as(_DP), reg)
        if rc != 0:
            raise ArithmeticError("sparse LDL: zero pivot")
        return self

    def solve(self, b):
        return _solve_columns(self._lib.hqp_ldl_solve, self._h, self.n, b)

    @property
    def nnz(self):
        return self._lib.hqp_ldl_nnz(self._h)

    @property
    def n_floored(self):
        """Pivots of the last factorization floored at ``reg``."""
        return self._lib.hqp_ldl_nfloored(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hqp_ldl_destroy(self._h)


class SparseBKP:
    """Sparse Bunch-Kaufman-Parlett factorization P'AP = MDM' of a
    symmetric indefinite matrix in full CSR form, with 1x1 and 2x2
    pivots (hqp/spBKP.C:369 spBKPfactor).  ``tol`` scales the pivot test
    (1.0 is the textbook alpha, spBKP.C:392); ``reg`` floors a small 1x1
    pivot, and a zero one is pinned to 1.0 (:attr:`n_pinned` counts
    both)."""

    def __init__(self, n, rowptr, colind, values, tol=1.0, reg=0.0):
        rowptr, colind, vals = _csr(n, rowptr, colind, values)
        self.n = n
        self._lib = library()
        self._h = self._lib.hqp_bkp_factor(
            n, rowptr.ctypes.data_as(_IP), colind.ctypes.data_as(_IP),
            vals.ctypes.data_as(_DP), tol, reg)
        if not self._h:
            raise MemoryError("sparse BKP: allocation failure")

    def solve(self, b):
        return _solve_columns(self._lib.hqp_bkp_solve, self._h, self.n, b)

    @property
    def nnz(self):
        return self._lib.hqp_bkp_nnz(self._h)

    @property
    def n_2x2(self):
        """Number of 2x2 pivot blocks chosen."""
        return self._lib.hqp_bkp_n2x2(self._h)

    @property
    def n_pinned(self):
        """1x1 pivots floored at ``reg`` or pinned to 1.0."""
        return self._lib.hqp_bkp_npinned(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hqp_bkp_destroy(self._h)
