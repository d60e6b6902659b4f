"""The yardstick of the kernels: the least time the card needs for the
work a cell's shapes call for.

A frozen copy of ``chip_smoke.py``'s ``bound``, ``gj_bound`` and
``thomas_bound``, taking sizes instead of tensors.  Each input byte is
read once and each output byte written once; the peaks are NVIDIA's data
sheet for one H100 SXM at its 700 W limit: 67 TFLOP/s in float64 (and
float32) outside the tensor cores, 3.35 TB/s of HBM3.  The work is
computed from the configuration's sizes (B, K, L -> P, s, b; N, n) and
the IP iterations each QP took, never from the program's launches, so a
later program that launches differently is held to the same work.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float64": 67e12, "float32": 67e12}
ELEMENT_BYTES = {"float64": 8, "float32": 4}


def bound_s(nbytes, flops, dtype="float64"):
    """(seconds, side): the least time of the card for this work."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def gj_bound_s(P, s, b, dtype="float64"):
    """K1 on P interiors of size s with b coupling columns: bytes, each
    input read once and each output written once (MII, MIB in; Minv, W,
    Schur out); FLOPs, the Gauss-Jordan inverse 2 s^3, W 2 s^2 b, Schur
    2 s b^2."""
    el = ELEMENT_BYTES[dtype]
    return bound_s(P * (2 * s * s + 2 * s * b + b * b) * el,
                   P * (2 * s ** 3 + 2 * s * s * b + 2 * s * b * b), dtype)


def thomas_bound_s(N, n, systems=1, dtype="float64"):
    """K2 on ``systems`` block-tridiagonal systems of N blocks of n x n:
    bytes, D, U and the right-hand side in and the solution out; FLOPs
    per block 2n^3 (U'G) + 4n^3 (inverse) + 2n^3 (CU) + 6n^2 + n."""
    el = ELEMENT_BYTES[dtype]
    nbytes = systems * (N * n * n + (N - 1) * n * n + 2 * N * n) * el
    return bound_s(nbytes, systems * N * (8 * n ** 3 + 6 * n * n + n),
                   dtype)


def choose_L(K, nx, nu, L):
    """The partition length the partitioned KKT takes for K stages at a
    requested L: a divisor of K near L, at least ceil(nx/nu) + 1 (a
    frozen copy of the rule of ``PartitionedKKT._choose_L``)."""
    Lmin = max(2, -(-nx // max(nu, 1)) + 1)
    for cand in range(min(L, K), 0, -1):
        if K % cand == 0 and cand >= Lmin:
            return cand
    for cand in range(min(L, K) + 1, K + 1):
        if K % cand == 0 and cand >= Lmin:
            return cand
    return K


def sizes(cfg, nx, nu):
    """The partitioned KKT's shapes at a configuration: partitions P of
    L stages, interiors of size s with b = 2 nx coupling columns, master
    of N = P + 1 blocks of n = nx, B problems."""
    K = cfg["kmax"]
    L = choose_L(K, nx, nu, cfg["L"])
    P = K // L
    nv = nx + nu
    return dict(K=K, L=L, P=P, s=nu + (L - 1) * nv + L * nx, b=2 * nx,
                N=P + 1, n=nx, B=int(cfg["batch"]))
