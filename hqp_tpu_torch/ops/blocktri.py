"""SPD block-tridiagonal factor/solve.

Port of ``hqp_tpu/ops/blocktri.py``: Jacobi equilibration, the sequential
block Cholesky (a Python loop; in the port it only serves the 1-2 block
base of cyclic reduction) and block cyclic reduction, the ``master="cr"``
option of :class:`~hqp_tpu_torch.qp.kkt_partitioned.PartitionedKKT` and
the float64 reference for the block-Thomas kernel
(:mod:`hqp_tpu_torch.ops.thomas_cuda`).

Block Cholesky of  T = tridiag(U', S, U):
    Ltilde_0 = chol(S_0);  W_k = Ltilde_k^-1 U_k;
    Ltilde_{k+1} = chol(S_{k+1} - W_k' W_k)
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import smalllin as sl

#: modified-Cholesky pivot floor (relative to the block diagonal) for the
#: master factorizations (hqp/Hqp_IpSpSC.C:46-48 spMODCHOLfac role)
MOD_CHOL_FLOOR = 1e-14


def equilibrate(S, U):
    """Jacobi scaling d = diag(S)^(-1/2); returns (D S D, D U D, d)
    (hqp/Hqp_IpRedSpBKP.C:299-313 role)."""
    d = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(S, dim1=-2, dim2=-1), min=1e-300))
    Ss = S * d[..., :, None] * d[..., None, :]
    Us = U * d[..., :-1, :, None] * d[..., 1:, None, :]
    return Ss, Us, d


def solve_scaled(L, W, d, rhs):
    """Solve the original system given factors of the equilibrated one
    (``equilibrate``'s d)."""
    return d * solve(L, W, d * rhs)


def factor(S, U):
    """S: [..., N, n, n] SPD diagonal blocks; U: [..., N-1, n, n] upper
    couplings (leading axes: a batch of systems).  Returns (L, W):
    per-block Cholesky factors and W_k = L_k^-1 U_k."""
    Ls, Ws = [], []
    Wprev = torch.zeros_like(S[..., 0, :, :])
    for k in range(S.shape[-3]):
        Lk = sl.chol(S[..., k, :, :] - Wprev.mT @ Wprev,
                     floor_rel=MOD_CHOL_FLOOR)
        Ls.append(Lk)
        if k < U.shape[-3]:
            Wprev = sl.tri_lower_solve(Lk, U[..., k, :, :])
            Ws.append(Wprev)
    L = torch.stack(Ls, dim=-3)
    W = torch.stack(Ws, dim=-3) if Ws else \
        S.new_zeros(S.shape[:-3] + (0,) + S.shape[-2:])
    return L, W


def solve(L, W, rhs):
    """Solve T x = rhs given factor(S, U) -> (L, W); rhs: [..., N, n]."""
    N = L.shape[-3]
    y = []
    for k in range(N):
        r = rhs[..., k, :] if k == 0 else \
            rhs[..., k, :] - sl.mv(W[..., k - 1, :, :].mT, y[-1])
        y.append(sl.tri_lower_solve(L[..., k, :, :], r))
    x = [None] * N
    for k in reversed(range(N)):
        r = y[k] if k == N - 1 else \
            y[k] - sl.mv(W[..., k, :, :], x[k + 1])
        x[k] = sl.tri_upper_solve(L[..., k, :, :], r)
    return torch.stack(x, dim=-2)


# ---------------------------------------------------------------------------
# Block cyclic reduction: log-depth factor/solve (every level eliminates
# all odd-indexed blocks at once with batched ops).
# ---------------------------------------------------------------------------


def cr_factor(S, U):
    """Cyclic-reduction factorization of SPD tridiag(U', S, U), over any
    leading batch axes.

    Returns ((levels...), base) consumed by cr_solve.  Each level, padded
    to an odd block count N = 2M+1 (identity diagonal, zero coupling):
        A_m = U[2m], B_m = U[2m+1], Lo = chol(D_odd),
        R_m = A_m D_odd_m^-1,  S_m = D_odd_m^-1 B_m,
        D' = D_even - [m>=1] B'S - [m<M] R A',  U'_m = -R_m B_m.
    """
    levels = []
    D, Uc = S, U
    n = S.shape[-1]
    while D.shape[-3] > 2:
        N = D.shape[-3]
        if N % 2 == 0:
            eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(
                D.shape[:-3] + (1, n, n))
            D = torch.cat([D, eye], -3)
            Uc = torch.cat([Uc, torch.zeros_like(eye)], -3)
            N += 1
        M = N // 2
        Dodd = D[..., 1::2, :, :]
        A = Uc[..., 0::2, :, :]
        B = Uc[..., 1::2, :, :]
        Lo = sl.chol(Dodd, floor_rel=MOD_CHOL_FLOOR)
        R = sl.cho_solve(Lo, A.transpose(-1, -2)).transpose(-1, -2)
        Sm = sl.cho_solve(Lo, B)
        Dn = D[..., 0::2, :, :].clone()
        Dn[..., :M, :, :] -= torch.einsum("...mij,...mkj->...mik", R, A)
        Dn[..., 1:, :, :] -= torch.einsum("...mji,...mjk->...mik", B, Sm)
        Un = -torch.einsum("...mij,...mjk->...mik", R, B)
        levels.append((Lo, R, Sm, A, B))
        D, Uc = Dn, Un
    return (tuple(levels), factor(D, Uc))


def cr_solve(fac, rhs):
    """Solve with cr_factor output; rhs: [..., N, n]."""
    levels, base = fac
    stack = []
    b = rhs
    for (Lo, R, Sm, A, B) in levels:
        N = b.shape[-2]
        if N % 2 == 0:
            b = torch.cat([b, torch.zeros_like(b[..., :1, :])], -2)
        M = b.shape[-2] // 2
        todd = sl.cho_solve(Lo, b[..., 1::2, :])
        bn = b[..., 0::2, :].clone()
        bn[..., :M, :] -= torch.einsum("...mij,...mj->...mi", A, todd)
        bn[..., 1:, :] -= torch.einsum("...mji,...mj->...mi", B, todd)
        stack.append((todd, N))
        b = bn
    x = solve(base[0], base[1], b)
    for (Lo, R, Sm, A, B), (todd, N) in zip(reversed(levels),
                                            reversed(stack)):
        xodd = (todd
                - torch.einsum("...mji,...mj->...mi", R, x[..., :-1, :])
                - torch.einsum("...mij,...mj->...mi", Sm, x[..., 1:, :]))
        M = xodd.shape[-2]
        out = x.new_zeros(x.shape[:-2] + (2 * M + 1, x.shape[-1]))
        out[..., 0::2, :] = x
        out[..., 1::2, :] = xodd
        x = out[..., :N, :]
    return x


def cr_solve_scaled(fac, d, rhs):
    """Solve the original system given CR factors of the equilibrated
    one."""
    return d * cr_solve(fac, d * rhs)
