"""Batched pivoted Gauss-Jordan interior inverse: CUDA kernel K1 + twin.

Port of the Pallas TPU kernel ``hqp_tpu/ops/gj_pallas.py::interior_factor``
(kernel sources: ``csrc/gj_interior.cu`` and, for interiors too large for
its tile, the cluster kernel ``csrc/gj_interior_large.cu``; :func:`route`
picks one by size, and :func:`cluster_size` the cluster kernel's width).
Per matrix of a batch it returns ``Minv = MII^-1``, ``W = Minv MIB`` and
``Schur = MIB' W``.

:func:`interior_factor` launches a kernel for CUDA tensors and takes the
plain version :func:`interior_factor_plain` only for CPU tensors.  All run
the same algorithm: Gauss-Jordan IN PLACE with partial pivoting (pivot =
first max of |column k| over rows >= k, NaN never wins), so all take the
TPU kernel's pivot sequence, and round the elimination alike, so their
inverses agree to the last bit.  The twin swaps rows and undoes the
interchanges on the columns at the end; both kernels leave the rows where
they are and read the result out through the interchanges.  Unlike the
TPU kernel, the port keeps the input dtype: float64 or float32.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.ops import _build

#: the largest interior of the "large" route (the TPU kernel's limit)
MAX_LARGE = 512
#: cluster sizes of the large kernel, in the order :func:`cluster_size`
#: tries them: by device time per launch, fastest first, at s = 152, 245
#: and 512 in f64 on an H100 (chip_smoke.py phase 9 times all three)
CLUSTERS = (16, 8, 4)
#: warps of one block of the large kernel, and the band bytes one of its
#: threads may hold in registers (csrc/gj_interior_large.cu)
LARGE_WARPS = 16
LARGE_REG_BYTES = 256
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


def _r16(n):
    return (n + 15) & ~15


def large_smem(s, b, dtype, C) -> int:
    """Bytes of shared memory one block of the large kernel takes for an
    interior of size s with b boundary columns in a cluster of C blocks:
    the kernel's ``layout`` (csrc/gj_interior_large.cu), which
    chip_smoke.py holds this copy against.  MIB is a staged region (16
    bytes of slack); then 2 C pushed entries (a 16-byte candidate header
    and a row) and 2 outgoing ones, two mbarriers, the warps' and the
    block's candidates, the step's pivot, the logical -> row map, the
    band's logical positions, its W and the Schur partial."""
    el = torch.finfo(dtype).bits // 8
    R = -(-s // C)
    entry = _r16(16 + s * el)
    return (_r16(s * b * el + 16) + (2 * C + 2) * entry + 16
            + (LARGE_WARPS + 2) * 16 + _r16(4 * s) + _r16(4 * R)
            + _r16(R * b * el) + _r16(b * b * el))


def large_regs(s, dtype, C) -> int:
    """Bytes of the band one thread of the large kernel holds in registers
    (rows a warp owns, rounded to 1, 2 or 4, times columns a lane owns, 8
    or 16); 0 where a warp would own more than 4 rows."""
    rows = -(-s // C)                    # the band
    nr = -(-rows // LARGE_WARPS)         # rows a warp owns
    nr = 1 if nr <= 1 else 2 if nr <= 2 else 4 if nr <= 4 else 0
    return nr * (8 if s <= 256 else 16) * (torch.finfo(dtype).bits // 8)


def cluster_size(s, b, dtype, limit) -> int:
    """The large kernel's cluster size for an interior of size s with b
    boundary columns: the first of ``CLUSTERS`` whose band fits a thread's
    ``LARGE_REG_BYTES`` of registers and whose block fits the opt-in shared
    memory ``limit`` (232448 bytes on an H100).  s = 512 in f64 fits only
    at 16."""
    for C in CLUSTERS:
        if 0 < large_regs(s, dtype, C) <= LARGE_REG_BYTES and \
                large_smem(s, b, dtype, C) <= limit:
            return C
    raise ValueError(f"no cluster of {CLUSTERS} holds s={s}, b={b} in "
                     f"{limit} bytes a block")


def smem_limit(device) -> int:
    """The opt-in shared memory one block may use on ``device``."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def route(s, b, dtype, device) -> str:
    """Which route a CUDA batch of interiors of size s with b coupling
    columns takes, by an explicit size rule:

    - ``"tile"``: the register kernel (``csrc/gj_interior.cu``) wherever
      its tile fits one block's opt-in shared memory (on an H100, s up to
      151 in f64 with b = 10);
    - ``"large"``: the cluster kernel (``csrc/gj_interior_large.cu``)
      above that, up to ``MAX_LARGE`` = 512, the TPU kernel's own limit
      (hqp_tpu/ops/gj_pallas.py:52-54);
    - ``"inv"``: ``torch.linalg.inv`` above 512, as the JAX package
      inverts outside its kernel (hqp_tpu/qp/kkt_partitioned.py:607)."""
    limit = smem_limit(device)
    lib = _build.library()
    smem = lib.hqp_gj_interior_smem_f64 if dtype == torch.float64 else \
        lib.hqp_gj_interior_smem_f32
    if smem(s, b) <= limit:
        return "tile"
    return "large" if s <= MAX_LARGE else "inv"


def _check(MII, MIB):
    """Refuse what no kernel takes; returns (s, b)."""
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
    return s, MIB.shape[-1]


def _launch(fn, MII, MIB, *extra):
    """Outputs, one launch of ``fn`` on the current stream, its check."""
    s, b = MII.shape[-1], MIB.shape[-1]
    Minv = torch.empty_like(MII)
    W = torch.empty_like(MIB)
    Schur = torch.empty(MII.shape[:-2] + (b, b), dtype=MII.dtype,
                        device=MII.device)
    with torch.cuda.device(MII.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(MII.data_ptr(), MIB.data_ptr(), Minv.data_ptr(),
                 W.data_ptr(), Schur.data_ptr(), MII.numel() // (s * s), s,
                 b, *extra, stream)
    _build.check(err, f"{fn.__name__} launch" +
                 (" (no cluster of that size fits)" if err == -2 else ""))
    return Minv, W, Schur


def interior_factor(MII, MIB):
    """(Minv, W, Schur) of every matrix of the batch.

    CPU tensors: :func:`interior_factor_plain`.  CUDA tensors: one launch
    of the route :func:`route` names over the flattened batch, or an
    exception -- never a fallback from one route to another."""
    global LAUNCHES, LAUNCHES_INV
    if MII.device.type == "cpu" and MIB.device.type == "cpu":
        return interior_factor_plain(MII, MIB)
    s, b = _check(MII, MIB)
    way = route(s, b, MII.dtype, MII.device)
    if way == "inv":
        Minv = torch.linalg.inv(MII)
        W = Minv @ MIB
        LAUNCHES_INV += 1
        return Minv, W, MIB.transpose(-1, -2) @ W
    if way == "large":
        return large_factor(MII, MIB, cluster_size(s, b, MII.dtype,
                                                   smem_limit(MII.device)))
    lib = _build.library()
    out = _launch(lib.hqp_gj_interior_f64 if MII.dtype == torch.float64
                  else lib.hqp_gj_interior_f32, MII, MIB)
    LAUNCHES += 1
    return out


def large_factor(MII, MIB, cluster):
    """The large route: one launch of the cluster kernel, ``cluster``
    blocks (4, 8 or 16) a matrix, on CUDA tensors with s <= 512.
    :func:`interior_factor` takes it with :func:`cluster_size`'s choice;
    chip_smoke.py also times the other sizes.  Raises if the size does not
    fit or no cluster of it fits on the device."""
    global LAUNCHES_LARGE
    _check(MII, MIB)
    lib = _build.library()
    out = _launch(lib.hqp_gj_large_f64 if MII.dtype == torch.float64
                  else lib.hqp_gj_large_f32, MII, MIB, cluster)
    LAUNCHES_LARGE += 1
    return out
