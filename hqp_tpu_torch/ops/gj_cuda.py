"""Batched pivoted Gauss-Jordan interior inverse: CUDA kernel K1 + twin.

Port of the Pallas TPU kernel ``hqp_tpu/ops/gj_pallas.py::interior_factor``
(kernel source: ``csrc/gj_interior.cu``).  Per matrix of a batch it
returns ``Minv = MII^-1``, ``W = Minv MIB`` and ``Schur = MIB' W``.

:func:`interior_factor` launches the kernel for CUDA tensors and takes the
plain version :func:`interior_factor_plain` only for CPU tensors.  Both run
the same algorithm: Gauss-Jordan IN PLACE with partial pivoting (pivot =
first max of |column k| over rows >= k, NaN never wins), so both take the
TPU kernel's pivot sequence, and round the elimination alike, so their
inverses agree to the last bit.  The twin swaps rows and undoes the
interchanges on the columns at the end; the kernel leaves the rows where
they are and reads the result out through the interchanges.  Unlike the
TPU kernel, the port keeps the input dtype: float64 or float32.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import _build

#: kernel launches since import (the main path adds one per factorization)
LAUNCHES = 0


def interior_factor_plain(MII, MIB):
    """Plain torch twin of the kernel, vectorised over the batch.

    MII: [..., s, s]; MIB: [..., s, b].  Returns (Minv, W, Schur)."""
    lead = MII.shape[:-2]
    s = MII.shape[-1]
    a = MII.reshape(-1, s, s).clone()
    B = MIB.reshape(-1, s, MIB.shape[-1])
    ar = torch.arange(a.shape[0], device=a.device)
    rows = torch.arange(s, device=a.device)
    pivs = []
    for k in range(s):
        v = a[:, :, k].abs()
        v = torch.where(torch.isnan(v), -1.0, v)
        v = torch.where(rows >= k, v, -2.0)
        p = torch.argmax(v, dim=1)                 # first max (ties: lowest)
        rk = a[:, k, :].clone()
        a[:, k, :] = a[ar, p, :]
        a[ar, p, :] = rk
        pinv = 1.0 / a[:, k, k]
        col = a[:, :, k].clone()
        rowk = a[:, k, :] * pinv[:, None]
        rowk[:, k] = pinv
        a = a - col[:, :, None] * rowk[:, None, :]
        a[:, :, k] = -col * pinv[:, None]
        a[:, k, :] = rowk
        pivs.append(p)
    for k in reversed(range(s)):
        p = pivs[k]
        ck = a[:, :, k].clone()
        a[:, :, k] = a[ar, :, p]
        a[ar, :, p] = ck
    W = a @ B
    Schur = B.transpose(-1, -2) @ W
    b = B.shape[-1]
    return (a.reshape(*lead, s, s), W.reshape(*lead, s, b),
            Schur.reshape(*lead, b, b))


def _smem_fn(lib, dtype):
    return lib.hqp_gj_interior_smem_f64 if dtype == torch.float64 else \
        lib.hqp_gj_interior_smem_f32


def interior_factor(MII, MIB):
    """(Minv, W, Schur) of every matrix of the batch.

    CPU tensors: :func:`interior_factor_plain`.  CUDA tensors: one launch
    of the kernel over the flattened batch, or an exception -- never a
    fallback."""
    global LAUNCHES
    if MII.device.type == "cpu" and MIB.device.type == "cpu":
        return interior_factor_plain(MII, MIB)
    if MII.device.type != "cuda" or MIB.device != MII.device:
        raise ValueError(f"interior_factor: tensors on {MII.device} and "
                         f"{MIB.device}; need both on one CUDA device")
    if MII.dtype not in (torch.float32, torch.float64) or \
            MIB.dtype != MII.dtype:
        raise TypeError(f"interior_factor: dtypes {MII.dtype}/{MIB.dtype}; "
                        "need matching float32 or float64")
    s = MII.shape[-1]
    if MII.dim() < 3 or MII.shape[-2] != s or MIB.dim() != MII.dim() or \
            MIB.shape[:-1] != MII.shape[:-1]:
        raise ValueError(f"interior_factor: shapes {tuple(MII.shape)} and "
                         f"{tuple(MIB.shape)}; need [..., s, s], [..., s, b]")
    if not (MII.is_contiguous() and MIB.is_contiguous()):
        raise ValueError("interior_factor: inputs must be contiguous")
    lib = _build.library()
    limit = torch.cuda.get_device_properties(
        MII.device).shared_memory_per_block_optin
    b = MIB.shape[-1]
    if _smem_fn(lib, MII.dtype)(s, b) > limit:
        raise ValueError(f"interior_factor: s = {s}, b = {b} needs more "
                         f"shared memory than the device's {limit} bytes")
    nb = MII.numel() // (s * s)
    Minv = torch.empty_like(MII)
    W = torch.empty_like(MIB)
    Schur = torch.empty(MII.shape[:-2] + (b, b), dtype=MII.dtype,
                        device=MII.device)
    fn = lib.hqp_gj_interior_f64 if MII.dtype == torch.float64 else \
        lib.hqp_gj_interior_f32
    with torch.cuda.device(MII.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(MII.data_ptr(), MIB.data_ptr(), Minv.data_ptr(),
                 W.data_ptr(), Schur.data_ptr(), nb, s, b, stream)
    _build.check(err, "gj_interior kernel launch")
    LAUNCHES += 1
    return Minv, W, Schur
