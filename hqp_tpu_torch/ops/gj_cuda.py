"""Batched pivoted Gauss-Jordan interior inverse: CUDA kernel K1 + twin.

Port of the Pallas TPU kernel ``hqp_tpu/ops/gj_pallas.py::interior_factor``
(kernel sources: ``csrc/gj_interior.cu`` and, for interiors too large for
its tile, ``csrc/gj_interior_large.cu``; :func:`route` picks one by size).
Per matrix of a batch it returns ``Minv = MII^-1``, ``W = Minv MIB`` and
``Schur = MIB' W``.

:func:`interior_factor` launches a kernel for CUDA tensors and takes the
plain version :func:`interior_factor_plain` only for CPU tensors.  All run
the same algorithm: Gauss-Jordan IN PLACE with partial pivoting (pivot =
first max of |column k| over rows >= k, NaN never wins), so all take the
TPU kernel's pivot sequence, and round the elimination alike, so their
inverses agree to the last bit.  The twin and the large kernel swap rows
and undo the interchanges on the columns at the end; the register kernel
leaves the rows where they are and reads the result out through the
interchanges.  Unlike the TPU kernel, the port keeps the input dtype:
float64 or float32.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import _build

#: the largest interior of the "large" route (the TPU kernel's limit)
MAX_LARGE = 512
#: launches since import, one counter per route (the main path adds one
#: per factorization): the register kernel, the large kernel, and the
#: torch.linalg.inv calls above MAX_LARGE
LAUNCHES = 0
LAUNCHES_LARGE = 0
LAUNCHES_INV = 0


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


def route(s, b, dtype, device) -> str:
    """Which route a CUDA batch of interiors of size s with b coupling
    columns takes, by an explicit size rule:

    - ``"tile"``: the register kernel (``csrc/gj_interior.cu``) wherever
      its tile fits one block's opt-in shared memory (on an H100, s up to
      151 in f64 with b = 10);
    - ``"large"``: the global-memory kernel (``csrc/gj_interior_large.cu``)
      above that, up to ``MAX_LARGE`` = 512, the TPU kernel's own limit
      (hqp_tpu/ops/gj_pallas.py:52-54);
    - ``"inv"``: ``torch.linalg.inv`` above 512, as the JAX package
      inverts outside its kernel (hqp_tpu/qp/kkt_partitioned.py:607)."""
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    lib = _build.library()
    smem = lib.hqp_gj_interior_smem_f64 if dtype == torch.float64 else \
        lib.hqp_gj_interior_smem_f32
    if smem(s, b) <= limit:
        return "tile"
    return "large" if s <= MAX_LARGE else "inv"


def interior_factor(MII, MIB):
    """(Minv, W, Schur) of every matrix of the batch.

    CPU tensors: :func:`interior_factor_plain`.  CUDA tensors: one launch
    of the route :func:`route` names over the flattened batch, or an
    exception -- never a fallback from one route to another."""
    global LAUNCHES, LAUNCHES_LARGE, LAUNCHES_INV
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
    b = MIB.shape[-1]
    way = route(s, b, MII.dtype, MII.device)
    if way == "inv":
        Minv = torch.linalg.inv(MII)
        W = Minv @ MIB
        LAUNCHES_INV += 1
        return Minv, W, MIB.transpose(-1, -2) @ W
    lib = _build.library()
    nb = MII.numel() // (s * s)
    Minv = torch.empty_like(MII)
    W = torch.empty_like(MIB)
    Schur = torch.empty(MII.shape[:-2] + (b, b), dtype=MII.dtype,
                        device=MII.device)
    f64 = MII.dtype == torch.float64
    if way == "tile":
        fn = lib.hqp_gj_interior_f64 if f64 else lib.hqp_gj_interior_f32
    else:
        fn = lib.hqp_gj_large_f64 if f64 else lib.hqp_gj_large_f32
    with torch.cuda.device(MII.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(MII.data_ptr(), MIB.data_ptr(), Minv.data_ptr(),
                 W.data_ptr(), Schur.data_ptr(), nb, s, b, stream)
    _build.check(err, f"gj_interior ({way}) kernel launch")
    if way == "tile":
        LAUNCHES += 1
    else:
        LAUNCHES_LARGE += 1
    return Minv, W, Schur
