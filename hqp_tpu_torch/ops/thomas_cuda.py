"""Batched block-Thomas solve: CUDA kernel K2 + plain twin.

Port of the Pallas TPU kernel ``hqp_tpu/ops/thomas_pallas.py::thomas_solve``
(kernel source: ``csrc/thomas.cu``).  Solves the SPD block-tridiagonal
system ``tridiag(U', D, U) x = rhs`` by the forward sweep (storing G, g)
and the backward sweep, inverting each n x n block by Gauss-Jordan without
pivoting -- safe after ``blocktri.equilibrate``, which the caller applies.

:func:`thomas_solve` launches the kernel for CUDA tensors and takes
:func:`thomas_solve_plain` only for CPU tensors.  Unlike the TPU kernel
(f32 only), both keep the input dtype: float64 or float32.  Leading
batch axes are optional: D [..., N, n, n] (a scenario batch's masters:
[B, N, n, n]); the kernel takes them flattened, one warp a system.
:func:`thomas_solve_scaled` is the reference's equilibrated wrapper
(``thomas_pallas.thomas_solve_scaled``) around the same kernel.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import _build

#: largest block the kernel takes (a warp holds one block, two elements a
#: lane)
MAX_BLOCK = 8

#: kernel launches since import
LAUNCHES = 0


def _inv_nopiv(A):
    """Batched [..., n, n] inverse by Gauss-Jordan without pivoting (the
    TPU kernel's _inv_unrolled, row k scaled by 1/pivot then eliminated)."""
    n = A.shape[-1]
    A = A.clone()
    M = torch.eye(n, dtype=A.dtype, device=A.device).expand_as(A).clone()
    for k in range(n):
        ip = 1.0 / A[..., k, k]
        ak = A[..., k, :] * ip[..., None]
        mk = M[..., k, :] * ip[..., None]
        cr = A[..., :, k].clone()
        cr[..., k] = 0.0
        A = A - cr[..., :, None] * ak[..., None, :]
        M = M - cr[..., :, None] * mk[..., None, :]
        A[..., k, :] = ak
        M[..., k, :] = mk
    return M


def thomas_solve_plain(D, U, rhs):
    """Plain torch twin: the same sweeps as a Python loop over N."""
    N = D.shape[-3]
    G, g = [], []
    for i in range(N):
        S, r = D[..., i, :, :], rhs[..., i, :]
        if i > 0:
            Ut = U[..., i - 1, :, :].transpose(-1, -2)
            S = S - Ut @ G[-1]
            r = r - (Ut @ g[-1][..., None])[..., 0]
        C = _inv_nopiv(S)
        G.append(C @ U[..., i, :, :] if i < N - 1 else torch.zeros_like(C))
        g.append((C @ r[..., None])[..., 0])
    x = [None] * N
    x[N - 1] = g[N - 1]
    for i in reversed(range(N - 1)):
        x[i] = g[i] - (G[i] @ x[i + 1][..., None])[..., 0]
    return torch.stack(x, dim=-2)


def _fn(lib, name, dtype):
    return getattr(lib, name + ("_f64" if dtype == torch.float64 else "_f32"))


def plan(N, n, dtype):
    """How the kernel takes a system of N blocks of n x n: 0 staged whole
    in shared memory, 1 staged whole with G and g in global scratch, 2
    streamed through its two-chunk ring (too large to stage at once)."""
    return _fn(_build.library(), "hqp_thomas_plan", dtype)(N, n)


def thomas_solve(D, U, rhs):
    """Solve tridiag(U', D, U) x = rhs.  D: [..., N, n, n], U: [..., N-1,
    n, n], rhs: [..., N, n].

    CPU tensors: :func:`thomas_solve_plain`.  CUDA tensors: one launch of
    the kernel with one warp per system, or an exception -- never a
    fallback."""
    global LAUNCHES
    devs = {D.device, U.device, rhs.device}
    if all(d.type == "cpu" for d in devs):
        return thomas_solve_plain(D, U, rhs)
    if len(devs) != 1 or D.device.type != "cuda":
        raise ValueError(f"thomas_solve: tensors on {devs}; need one CUDA "
                         "device")
    if D.dtype not in (torch.float32, torch.float64) or \
            U.dtype != D.dtype or rhs.dtype != D.dtype:
        raise TypeError("thomas_solve: need matching float32 or float64, "
                        f"got {D.dtype}/{U.dtype}/{rhs.dtype}")
    N, n = D.shape[-3], D.shape[-1]
    lead = D.shape[:-3]
    if D.dim() < 3 or D.shape[-2] != n or \
            U.shape != lead + (N - 1, n, n) or rhs.shape != lead + (N, n):
        raise ValueError(f"thomas_solve: shapes {tuple(D.shape)}, "
                         f"{tuple(U.shape)}, {tuple(rhs.shape)}")
    if n > MAX_BLOCK:
        raise ValueError(f"thomas_solve: block size {n} > {MAX_BLOCK}")
    if not (D.is_contiguous() and U.is_contiguous()
            and rhs.is_contiguous()):
        raise ValueError("thomas_solve: inputs must be contiguous")
    nb = D.numel() // max(N * n * n, 1)
    x = torch.empty_like(rhs)
    if nb == 0 or N == 0:
        return x
    lib = _build.library()
    G = g = None
    if _fn(lib, "hqp_thomas_plan", D.dtype)(N, n) > 0:
        # G and g do not fit beside the system in shared memory.  Dropped
        # on return while the launch may still run: safe, as the caching
        # allocator gives freed blocks only to later work on the same
        # stream
        G, g = torch.empty_like(D), torch.empty_like(rhs)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(lib, "hqp_thomas", D.dtype)(
            D.data_ptr(), U.data_ptr(), rhs.data_ptr(), x.data_ptr(),
            None if G is None else G.data_ptr(),
            None if g is None else g.data_ptr(), nb, N, n, stream)
    _build.check(err, "thomas kernel launch")
    LAUNCHES += 1
    return x


def thomas_solve_scaled_plain(D, U, d, rhs):
    """Plain twin of :func:`thomas_solve_scaled`."""
    return d * thomas_solve_plain(D, U, d * rhs)


def thomas_solve_scaled(D, U, d, rhs):
    """The equilibrated solve d * thomas_solve(D, U, d * rhs): (D, U) the
    equilibrated blocks and d [..., N, n] the Jacobi scaling
    (``blocktri.equilibrate``), the contract of ``blocktri.solve_scaled``.
    One K2 launch on CUDA tensors, the plain twin on CPU tensors."""
    return d * thomas_solve(D, U, (d * rhs).contiguous())
