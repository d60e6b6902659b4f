"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device and toolchain: nvidia-smi name and power limit, torch, CUDA,
     nvcc versions; exits at once without a CUDA device;
  2. nvcc build of hqp_tpu_torch/csrc into build/hqp_tpu_torch/;
  3. kernel K1 (batched pivoted Gauss-Jordan) against its plain twin;
  4. kernel K2 (batched block-Thomas) against its plain twin;
  5. kernel and plain times at the main path's shapes (CUDA events,
     median of 20);
  6. SqpPowell(PrgDID(kmax=60)) on the card: optimal at 98.4;
  7. SqpPowell(PrgDID(kmax=1000)) on the card, init/simulate/solve cold
     then warm: optimal at the reference objective, with both kernels'
     launch counts, host syncs per IP iteration and solve times.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: DID-1000 objective of the JAX reference package on a CPU host in f64:
#: SqpPowell(PrgDID(kmax=1000), max_iters=50, qp_eps=1e-7) after
#: init/simulate/solve -> "optimal" in 1 SQP and 27 IP iterations
REF_F_DID1000 = 88.91363105840026
#: bench.py's acceptance window for the DID-1000 objective
BENCH_F_DID1000, BENCH_TOL = 88.9064, 1e-2
#: the QP tolerance of every recorded reference DID-1000 run: with the
#: default 1e-9 the f64 interior point stalls at mu ~ 3.6e-9 on
#: SIGMA_CAP-capped rows and the SQP raises "subiters", in the reference
#: package and in the port alike (ROADMAP Q3 R7; PERF.md gives the
#: reference's command and output, and phase 4 of
#: ``python -m hqp_tpu_torch.prof_did1000`` shows the port's on the card)
QP_EPS_DID1000 = 1e-7


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def median_ms(fn, reps=20):
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gj_inputs(P, s, b, dtype, seed, swap=False):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((P, s, s)) + 4.0 * np.eye(s)
    if swap:
        M[:, 0, 0] = 0.0       # forces a row interchange at step 0
    B = rng.standard_normal((P, s, b))
    return (torch.as_tensor(M, dtype=dtype, device="cuda"),
            torch.as_tensor(B, dtype=dtype, device="cuda"))


def thomas_inputs(B, N, n, dtype, seed):
    """Equilibrated SPD block-tridiagonal systems (unit diagonal blocks
    after Jacobi scaling, as the master solve hands them over)."""
    from hqp_tpu_torch.ops import blocktri
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((B, N - 1, n, n)) * 0.3 / n
    X = rng.standard_normal((B, N, n, n)) * 0.1
    D = np.eye(n) * 3.0 + 0.5 * (X + np.swapaxes(X, -1, -2))
    Ds, Us, _ = blocktri.equilibrate(torch.as_tensor(D), torch.as_tensor(U))
    r = rng.standard_normal((B, N, n))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
                 for a in (Ds, Us, r))


def main():
    # -- 1. device and toolchain -----------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.ops import _build, gj_cuda, thomas_cuda
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.utils import sync

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("[1] " + run([_build.nvcc_path(), "--version"]).splitlines()[-1])

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.INFO['seconds']:.1f} s, built="
          f"{_build.INFO['built']}) -> {_build.INFO['path']}")
    for ln in _build.INFO["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("[2]   " + ln.strip())

    # -- 3. K1 against its plain twin -------------------------------------
    tol = {torch.float64: 1e-10, torch.float32: 1e-3}
    errs = {"gj": 0.0, "thomas": 0.0}
    cases = [(100, 48, 4, torch.float64, False),
             (100, 48, 4, torch.float32, False),
             (4, 73, 4, torch.float64, False),
             (11, 17, 4, torch.float64, True),
             (11, 17, 4, torch.float32, True)]
    for i, (P, s, b, dt, swap) in enumerate(cases):
        M, B = gj_inputs(P, s, b, dt, seed=i, swap=swap)
        out = gj_cuda.interior_factor(M, B)
        ref = gj_cuda.interior_factor_plain(M, B)
        torch.cuda.synchronize()
        e = [rel_err(o, r) for o, r in zip(out, ref)]
        eye = torch.eye(s, dtype=dt, device="cuda")
        resid = float((out[0] @ M - eye).abs().max())
        print(f"[3] K1 P={P} s={s} b={b} {str(dt)[6:]} swap={swap}: "
              f"rel err Minv {e[0]:.2e} W {e[1]:.2e} Schur {e[2]:.2e}; "
              f"|Minv M - I| {resid:.2e}")
        check(max(e) <= tol[dt], f"K1 disagrees with its twin ({e})")
        check(resid <= 100 * tol[dt], f"K1 inverse residual {resid}")
        if (P, s, dt) == (100, 48, torch.float64):
            errs["gj"] = float((out[0] - ref[0]).abs().max())

    # -- 4. K2 against its plain twin -------------------------------------
    for i, (Bn, N, n, dt) in enumerate([
            (1, 101, 2, torch.float64), (1, 101, 2, torch.float32),
            (3, 101, 6, torch.float64), (3, 101, 6, torch.float32)]):
        D, U, r = thomas_inputs(Bn, N, n, dt, seed=10 + i)
        x = thomas_cuda.thomas_solve(D, U, r)
        xr = thomas_cuda.thomas_solve_plain(D, U, r)
        torch.cuda.synchronize()
        e = rel_err(x, xr)
        print(f"[4] K2 B={Bn} N={N} n={n} {str(dt)[6:]}: rel err {e:.2e}")
        check(e <= tol[dt], f"K2 disagrees with its twin ({e})")
        if (Bn, n, dt) == (1, 2, torch.float64):
            errs["thomas"] = float((x - xr).abs().max())

    # -- 5. times at the main path's shapes --------------------------------
    times = {}
    M, B = gj_inputs(100, 48, 4, torch.float64, seed=0)
    times["gj"] = (median_ms(lambda: gj_cuda.interior_factor(M, B)),
                   median_ms(lambda: gj_cuda.interior_factor_plain(M, B)))
    D, U, r = thomas_inputs(1, 101, 2, torch.float64, seed=10)
    D, U, r = D[0], U[0], r[0]
    times["thomas"] = (median_ms(lambda: thomas_cuda.thomas_solve(D, U, r)),
                       median_ms(lambda: thomas_cuda.thomas_solve_plain(
                           D, U, r)))
    for k, (kt, pt) in times.items():
        print(f"[5] {k}: kernel {kt:.4f} ms, plain {pt:.4f} ms "
              f"(median of 20, f64, main-path shape) on {smi}")

    # -- 6. DID-60 ----------------------------------------------------------
    s = SqpPowell(PrgDID(kmax=60, device="cuda"), max_iters=50)
    s.init()
    res = s.solve()
    f60 = float(s.f)
    print(f"[6] DID-60: {res}, f = {f60!r}, SQP {s.iter}, IP "
          f"{s.qp_iters_total}")
    check(res == "optimal" and abs(f60 - 98.4) <= 1e-4, "DID-60")

    # -- 7. DID-1000, the main path ------------------------------------------
    def did1000(tag):
        gj_cuda.LAUNCHES = thomas_cuda.LAUNCHES = 0
        sync.COUNT = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = SqpPowell(PrgDID(kmax=1000, device="cuda"), max_iters=50,
                      qp_eps=QP_EPS_DID1000)
        s.init()
        s.simulate()
        res = s.solve()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"gj": gj_cuda.LAUNCHES, "thomas": thomas_cuda.LAUNCHES}
        f = float(s.f)
        check(s.qp.Q.is_cuda and s.qp.A.is_cuda and s.x.is_cuda,
              "QP tensors are not on the card")
        ip = s.qp_iters_total
        print(f"[7] DID-1000 {tag}: {res}, f = {f!r}, {secs:.3f} s, SQP "
              f"{s.iter}, IP {ip} ({ip / secs:.1f} IP it/s), host syncs "
              f"{sync.COUNT} ({sync.COUNT / max(ip, 1):.2f} per IP "
              f"iteration), launches K1 {launches['gj']} K2 "
              f"{launches['thomas']}, QP on {s.qp.Q.device}")
        check(res == "optimal", f"DID-1000 {tag}: {res}")
        check(abs(f - BENCH_F_DID1000) <= BENCH_TOL,
              f"DID-1000 objective {f} outside bench window")
        check(abs(f - REF_F_DID1000) <= 1e-4 * abs(REF_F_DID1000),
              f"DID-1000 objective {f} vs reference {REF_F_DID1000}")
        check(launches["gj"] > 0 and launches["thomas"] > 0,
              f"main path skipped a kernel: {launches}")
        return launches

    launches = did1000("cold")
    did1000("warm")

    kernels = [
        {"name": "gj_interior", "route": "cuda",
         "source": "hqp_tpu_torch/csrc/gj_interior.cu",
         "replaces": "hqp_tpu/ops/gj_pallas.py:138",
         "launches": launches["gj"], "max_abs_err": errs["gj"],
         "ms": times["gj"][0], "plain_ms": times["gj"][1]},
        {"name": "thomas", "route": "cuda",
         "source": "hqp_tpu_torch/csrc/thomas.cu",
         "replaces": "hqp_tpu/ops/thomas_pallas.py:128",
         "launches": launches["thomas"], "max_abs_err": errs["thomas"],
         "ms": times["thomas"][0], "plain_ms": times["thomas"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
