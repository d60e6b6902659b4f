"""Batched pivoted Gauss-Jordan interior inverse: CUDA kernel K1 + twin.

Port of the Pallas TPU kernel ``hqp_tpu/ops/gj_pallas.py::interior_factor``
(kernel sources: ``csrc/gj_interior_batch.cu``, two matrices an SM, for
s <= 98; ``csrc/gj_interior.cu``, one matrix an SM, above that; for
interiors too large for its tile, the cluster kernel
``csrc/gj_interior_large.cu``; :func:`route` picks one by size, and
:func:`cluster_size` the cluster kernel's width).
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

import ctypes

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
#: the batched route's tiles (csrc/gj_interior_batch.cu, ``by_tile``):
#: the largest interior each holds, the register rows and columns a
#: thread holds, and its warps; the route's largest interior; and the
#: matrices it keeps resident on one SM.  (chip_smoke.py phase 24 times
#: both register routes: the batched one is the faster at every batch it
#: times, one interior to hundreds of waves.)
BATCH_TILES = ((48, 3, 6, 4), (98, 6, 13, 4))
BATCH_MAX = BATCH_TILES[-1][0]
BATCH_RESIDENT = 2
#: shared memory the card reserves for each resident block (bytes): an
#: SM holds the opt-in limit of one block plus this
BLOCK_RESERVED = 1024
#: launches since import, one counter per route (the main path adds one
#: per factorization): the register kernels (both routes), the large
#: kernel, and the torch.linalg.inv calls above MAX_LARGE; and, of
#: LAUNCHES, those of the batched route
LAUNCHES = 0
LAUNCHES_LARGE = 0
LAUNCHES_INV = 0
LAUNCHES_BATCH = 0


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


def _el(dtype):
    return torch.finfo(dtype).bits // 8


def tile_smem(s, b, dtype) -> int:
    """Bytes of shared memory one block of the tile route takes for an
    interior of size s with b boundary columns: the kernel's ``layout``
    (csrc/gj_interior.cu), which chip_smoke.py holds this copy against.
    The staged matrix and MIB (16 bytes of slack each), column k twice,
    the 8 warps' candidate rows twice, W, the 8 warps' candidates twice
    (24 bytes each in float64, 16 in float32), the row maps."""
    el = _el(dtype)
    return (_r16(s * s * el + 16) + _r16(s * b * el + 16) + _r16(2 * s * el)
            + _r16(16 * s * el) + _r16(s * b * el)
            + _r16(16 * (24 if el == 8 else 16)) + 2 * _r16(4 * s))


def batch_smem(s, b, dtype) -> int:
    """Bytes of shared memory one block of the batched route takes for an
    interior of size s <= BATCH_MAX: the kernel's ``blayout``
    (csrc/gj_interior_batch.cu), which chip_smoke.py holds this copy
    against.  The staged matrix and MIB, column k twice over the rows
    of the register tile and the 16 past it (rp), the pivot twice
    (1/pivot and its row, padded to two elements), W, the logical
    positions over rp rows and the logical -> row map."""
    el = _el(dtype)
    rp = 16 * next(t for t in BATCH_TILES if s <= t[0])[1] + 16
    return (_r16(s * s * el + 16) + _r16(s * b * el + 16)
            + _r16(2 * rp * el) + _r16(4 * el) + _r16(s * b * el)
            + _r16(4 * rp) + _r16(4 * s))


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


def batch_fits(s, b, dtype, limit) -> bool:
    """Do BATCH_RESIDENT interiors of size s with b boundary columns fit
    one SM in the batched route?  Its tiles hold s <= BATCH_MAX in
    registers at two blocks an SM, and the blocks' shared memory, with
    what the card reserves for each, must fit the SM's: the opt-in
    ``limit`` of one block plus BLOCK_RESERVED."""
    return s <= BATCH_MAX and BATCH_RESIDENT * (
        batch_smem(s, b, dtype) + BLOCK_RESERVED) <= limit + BLOCK_RESERVED


def route_rule(s, b, dtype, limit) -> str:
    """Which route a CUDA batch of interiors of size s with b coupling
    columns takes on a card whose blocks may opt in to ``limit`` bytes of
    shared memory (232448 on an H100), by an explicit size rule:

    - ``"batch"``: the batched register kernel
      (``csrc/gj_interior_batch.cu``) where two interiors fit one SM
      (:func:`batch_fits`: s <= 98, the scenario batch's and DID-1000's);
    - ``"tile"``: the register kernel (``csrc/gj_interior.cu``) above
      that, wherever its tile fits one block's shared memory (on an H100,
      s up to 151 in f64 with b = 10: the crane's s = 124);
    - ``"large"``: the cluster kernel (``csrc/gj_interior_large.cu``)
      above that, up to ``MAX_LARGE`` = 512, the TPU kernel's own limit
      (hqp_tpu/ops/gj_pallas.py:52-54);
    - ``"inv"``: ``torch.linalg.inv`` above 512, as the JAX package
      inverts outside its kernel (hqp_tpu/qp/kkt_partitioned.py:607)."""
    if batch_fits(s, b, dtype, limit):
        return "batch"
    if tile_smem(s, b, dtype) <= limit:
        return "tile"
    return "large" if s <= MAX_LARGE else "inv"


def route(s, b, dtype, device) -> str:
    """:func:`route_rule` with the opt-in shared memory of ``device``."""
    return route_rule(s, b, dtype, smem_limit(device))


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
    global LAUNCHES_INV
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
    return batch_factor(MII, MIB) if way == "batch" else \
        tile_factor(MII, MIB)


def tile_factor(MII, MIB):
    """The tile route: one launch of the register kernel, a block and an
    SM a matrix, on CUDA tensors whose tile fits (:func:`tile_smem`).
    :func:`interior_factor` takes it by :func:`route` above BATCH_MAX;
    chip_smoke.py also runs it at s <= BATCH_MAX, against the batched
    route.  Raises where it does not fit."""
    global LAUNCHES
    _check(MII, MIB)
    lib = _build.library()
    out = _launch(lib.hqp_gj_interior_f64 if MII.dtype == torch.float64
                  else lib.hqp_gj_interior_f32, MII, MIB)
    LAUNCHES += 1
    return out


def batch_factor(MII, MIB):
    """The batched route: one launch of the batched register kernel, two
    matrices an SM, on CUDA tensors with s <= BATCH_MAX, at any batch.
    :func:`interior_factor` takes it by :func:`route`; chip_smoke.py and
    the card tests also launch it directly.  Counts in LAUNCHES and
    LAUNCHES_BATCH.  Raises where s does not fit."""
    global LAUNCHES, LAUNCHES_BATCH
    _check(MII, MIB)
    lib = _build.library()
    out = _launch(lib.hqp_gj_batch_f64 if MII.dtype == torch.float64
                  else lib.hqp_gj_batch_f32, MII, MIB)
    LAUNCHES += 1
    LAUNCHES_BATCH += 1
    return out


def kernel_attrs(way, s, b, dtype):
    """(interiors resident on one SM, registers a thread, spilled bytes a
    thread, threads a block) of the register kernel route ``way``
    ("tile" or "batch") takes at size s, from the CUDA runtime's
    occupancy query and function attributes on the current device."""
    lib = _build.library()
    fn = getattr(lib, f"hqp_gj_{'interior' if way == 'tile' else way}"
                 f"_attrs_{'f64' if dtype == torch.float64 else 'f32'}")
    out = (ctypes.c_int * 4)()
    _build.check(fn(s, b, ctypes.addressof(out)), f"{fn.__name__}")
    return tuple(out)


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
