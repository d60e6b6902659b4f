"""Small-matrix linear algebra, unrolled over the static block size.

Port of ``hqp_tpu/ops/smalllin.py`` (``chol``, triangular solves,
``cho_solve`` and the pivot-free LU routines of the implicit
integrators).  The per-stage blocks of the reference are tiny (a few to a
few dozen rows), so the routines unroll over the static dimension and
broadcast over any leading batch axes ([K] stages, [P] partitions, ...).
Above ``_UNROLL_LIMIT`` they defer to ``torch.linalg``.
"""

from __future__ import annotations

import torch

_UNROLL_LIMIT = 48


def chol(A, floor_rel=None):
    """Lower Cholesky factor of SPD blocks.

    ``floor_rel``: modified-Cholesky pivot safeguard (the reference's
    spMODCHOLfac role, hqp/Hqp_IpSpSC.C:46-48): each pivot d^2 is clamped
    below at ``floor_rel * max|diag(A)|`` so blocks that are PSD up to
    roundoff factor to a nearby SPD system instead of producing NaN; the
    caller's iterative refinement absorbs the perturbation."""
    n = A.shape[-1]
    if n > _UNROLL_LIMIT:
        return torch.linalg.cholesky(A)
    if floor_rel is not None:
        dmax = torch.diagonal(A, dim1=-2, dim2=-1).abs().amax(dim=-1)
        floor = floor_rel * torch.clamp(dmax, min=1e-300)
    cols = []
    for j in range(n):
        v = A[..., j:, j]
        for k in range(j):
            v = v - cols[k][..., j - k:] * cols[k][..., j - k, None]
        d2 = v[..., 0]
        if floor_rel is not None:
            d2 = torch.maximum(d2, floor)
        d = torch.sqrt(d2)
        cols.append(torch.cat([d[..., None], v[..., 1:] / d[..., None]],
                              dim=-1))
    L = torch.zeros_like(A)
    for j in range(n):
        L[..., j:, j] = cols[j]
    return L


def tri_lower_solve(L, b):
    """Solve L x = b, L lower triangular; b is [..., n] or [..., n, m]."""
    n = L.shape[-1]
    if n == 0:
        return b
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    if n > _UNROLL_LIMIT:
        x = torch.linalg.solve_triangular(L, b, upper=False)
        return x[..., 0] if vec else x
    xs = []
    for i in range(n):
        v = b[..., i, :]
        for k in range(i):
            v = v - L[..., i, k, None] * xs[k]
        xs.append(v / L[..., i, i, None])
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def tri_upper_solve(L, b):
    """Solve L' x = b with L lower triangular."""
    n = L.shape[-1]
    if n == 0:
        return b
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    if n > _UNROLL_LIMIT:
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), b,
                                          upper=True)
        return x[..., 0] if vec else x
    xs = [None] * n
    for i in reversed(range(n)):
        v = b[..., i, :]
        for k in range(i + 1, n):
            v = v - L[..., k, i, None] * xs[k]
        xs[i] = v / L[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def mv(A, v):
    """A @ v for matrices A [..., n, m] and vectors v [..., m]: the plain
    matrix-vector product for one matrix, a batched one otherwise."""
    return A @ v if A.dim() == 2 else (A @ v[..., None])[..., 0]


def cho_solve(L, b):
    """Solve A x = b given L = chol(A)."""
    return tri_upper_solve(L, tri_lower_solve(L, b))


def spd_solve(A, b):
    """Solve SPD A x = b by Cholesky."""
    return cho_solve(chol(A), b)


def lu_nopiv(A):
    """Unrolled LU WITHOUT pivoting (Doolittle) for small well-conditioned
    systems (integrator Newton matrices); one packed matrix (L below the
    diagonal, U on and above).  Built out of place, step by step, so that
    it composes with ``torch.func`` transforms."""
    n = A.shape[-1]
    if n > _UNROLL_LIMIT:
        raise ValueError("lu_nopiv: n too large to unroll")
    M = A
    for k in range(n):
        piv = M[..., k, k]
        lcol = M[..., k + 1:, k] / piv[..., None]
        rest = M[..., k + 1:, k + 1:] - \
            lcol[..., :, None] * M[..., k, k + 1:][..., None, :]
        low = torch.cat([M[..., k + 1:, :k], lcol[..., None], rest], dim=-1)
        M = torch.cat([M[..., :k + 1, :], low], dim=-2)
    return M


def lu_nopiv_solve(M, b):
    """Solve with the packed factor from :func:`lu_nopiv`."""
    n = M.shape[-1]
    if n == 0:
        return b
    vec = b.dim() == M.dim() - 1
    if vec:
        b = b[..., None]
    # forward: L y = b (unit diagonal)
    ys = []
    for i in range(n):
        v = b[..., i, :]
        for k in range(i):
            v = v - M[..., i, k, None] * ys[k]
        ys.append(v)
    # backward: U x = y
    xs = [None] * n
    for i in reversed(range(n)):
        v = ys[i]
        for k in range(i + 1, n):
            v = v - M[..., i, k, None] * xs[k]
        xs[i] = v / M[..., i, i, None]
    x = torch.stack(xs, dim=-2)
    return x[..., 0] if vec else x


def solve_nopiv(A, b):
    """Solve a general small A x = b by unrolled pivot-free LU."""
    return lu_nopiv_solve(lu_nopiv(A), b)


def inv_nopiv(A):
    """Inverse of small matrices by unrolled pivot-free LU."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return lu_nopiv_solve(lu_nopiv(A), eye)
