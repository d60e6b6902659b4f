"""Where a solve's time goes on the card (DID-1000, Crane, LQBlend,
scenarios, a hosted model).

    python -m hqp_tpu_torch.prof_did1000 [--kmax 1000] [--device cuda]
    python -m hqp_tpu_torch.prof_did1000 --program Crane [--kmax 50]
    python -m hqp_tpu_torch.prof_did1000 --program CraneDopri5 [--kmax 50]
    python -m hqp_tpu_torch.prof_did1000 --program LQBlend [--kmax 2000]
    python -m hqp_tpu_torch.prof_did1000 --program Scenarios256 [--kmax 256]
    python -m hqp_tpu_torch.prof_did1000 --program SFunctionOpt [--kmax 1000]
    python -m hqp_tpu_torch.prof_did1000 --program DIDMex [--kmax 1000]
    python -m hqp_tpu_torch.prof_did1000 --program SpSCdist [--kmax 1000]

Phases, each printed on lines of its own:
  1. chained KKT factor+solve links at the point of ``bench.py``'s
     did1000_kkt (Q = 1e-2 I, z = w = 1, L = 10), median of ``REPS``
     with a synchronize per link: f64 with the Thomas master (two passes),
     f64 with the CR master, f32 with the Thomas master, each with its
     factor / solve split and the KKT residual of the last link;
  2. the layer split of one warm SqpPowell solve (init, simulate, solve),
     by host timers that synchronize the device on entry and exit; each
     layer's time excludes the layers it calls; and the solve's host syncs
     per IP iteration;
  3. a torch.profiler trace of one more warm solve: device busy time,
     the device's idle share of the profiled window, kernels per IP
     iteration, and the kernels with the most device time;
  4. the same solve at the default QP tolerance (1e-9), which is expected
     to end in SqpError("subiters"), with the last QP's complementarity.
``--program Crane`` runs phases 2 and 3 on ``PrgCrane(K=kmax)`` (default
QP tolerance; phases 1 and 4 are DID's), ``--program CraneDopri5`` on
the same program with its stages integrated by the adaptive ``Dopri5``,
with the integrator's loops split out of make_qp and the line search (the
values' loop and the Jacobians' loop) and their iterations and host reads
per make_qp.  ``--program LQBlend`` runs them
on ``solve_generated``'s solver for ``PrgLQBlend(n=kmax)`` (the general
path: Nlp, the host-sparse SparseCallbackKKT, the Gerschgorin hela), with
its layers split out: the copies of Q, C and A to the host, the host's
saddle assembly and LDL' factorization, the host LDL' solves, the
right-hand side and solution copies, the exact Hessian and the hela
update.  ``--program Scenarios256`` runs them on one
batched solve of BASELINE config 5 (``kmax`` scenarios of DID-60, the
port's draws of seed 0, presolved at tau = 0.02, Mehrotra(PartitionedKKT(
L=20), eps=1e-9) through ``make_scenario_solve``), with the batched
make_qp, the presolve and the violation split out; there an "IP
iteration" is one step of the whole batch.  ``--program SFunctionOpt``
runs them on ``DynamicOpt`` over the hosted S-function ``sfun_dic`` at
K = kmax (chip_smoke.py phase 19's SFunctionOpt-1000: the soft-constraint
problem with u_order = 1 and slack controls; init, solve), with the hosted
model's batches ("hosted callbacks": the copy of a batch of stages to the
host, the C calls and finite differences there, the copy back) split out
of make_qp and the line search.  ``--program DIDMex`` runs them on
DID through the MEX-built demo S-function (``prg_name DID_MEX``, DID's
settings), with its hosted callbacks split out; ``--program SpSCdist`` on
DID with ``qp_mat_solver SpSCdist`` (ShardedPartitionedKKT over a one-rank
process group made without a launcher), with its collectives split out
of the KKT factor and solve.  Phase 3 needs a CUDA device
and is skipped
with ``--device cpu``, where the script serves only to check itself at a
small ``--kmax``.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import time
import types

import torch
import torch.distributed as dist

from hqp_tpu_torch.docp.nlp import Nlp
from hqp_tpu_torch.docp.program import Docp
from hqp_tpu_torch.hxi.sfunction import SFunction, demo_sfunction_path
from hqp_tpu_torch.models.crane import PrgCrane
from hqp_tpu_torch.models.did import PrgDID
from hqp_tpu_torch.models.hxi_suite import PrgDIDMex
from hqp_tpu_torch.models.nlp_gen import generated_solver
from hqp_tpu_torch.omu import hosted, integrators
from hqp_tpu_torch.omu.dynamic_opt import DynamicOpt
from hqp_tpu_torch.parallel import distributed, scenarios
from hqp_tpu_torch.parallel.sharded_kkt import ShardedPartitionedKKT
from hqp_tpu_torch.qp import kkt as K_
from hqp_tpu_torch.qp import kkt_sparse_host as sparse_host
from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
from hqp_tpu_torch.qp.mehrotra import Mehrotra
from hqp_tpu_torch.sqp import hessian
from hqp_tpu_torch.sqp.powell import SqpPowell
from hqp_tpu_torch.sqp.solver import SqpError
from hqp_tpu_torch.utils import masked as mk
from hqp_tpu_torch.utils import sync as host_sync

#: timed links per backend, after one warm-up link
REPS = 20


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def kkt_point(kmax, device):
    """bench.py's build_kkt: the DID QP at its initial point with
    Q = 1e-2 I, unit barrier data and the cold-start right-hand side."""
    prg = PrgDID(kmax=kmax, device=device)
    v0 = prg.setup()
    Q0 = (torch.eye(prg.nv, dtype=torch.float64, device=prg.device)
          * 1e-2).expand(prg.K + 1, -1, -1).clone()
    _, qp = prg.make_qp(v0, Q=Q0)
    mask = qp.ineq_mask()
    ones = mk.fill(mask, 1.0)
    rhs = (torch.where(qp.x_mask(), qp.c, 0.0), qp.eq_offsets(),
           mk.fill(mask, 0.0), mk.fill(mask, 0.0))
    return qp, mask, ones, rhs


def chained_links(kmax, device):
    qp, mask, ones, rhs = kkt_point(kmax, device)
    dev = qp.device
    for tag, be in [("f64 thomas", PartitionedKKT(L=10)),
                    ("f64 thomas (2nd pass)", PartitionedKKT(L=10)),
                    ("f64 cr", PartitionedKKT(L=10, master="cr")),
                    ("f32 thomas", PartitionedKKT(L=10, factor_dtype="f32"))]:
        fac_ms, sol_ms, link_ms = [], [], []
        r1 = rhs[0]
        for i in range(REPS + 1):
            sync(dev)
            t0 = time.perf_counter()
            fac = be.factor(qp, ones, ones, mask)
            sync(dev)
            t1 = time.perf_counter()
            sol = be.solve(fac, qp, ones, ones, mask, r1, *rhs[1:])
            sync(dev)
            t2 = time.perf_counter()
            if i:                         # the first link is a warm-up
                fac_ms.append((t1 - t0) * 1e3)
                sol_ms.append((t2 - t1) * 1e3)
                link_ms.append((t2 - t0) * 1e3)
            last = (r1, sol)
            # chain the links as bench.py does: the next rhs depends on
            # this link's solution by a bump far below any tolerance
            r1 = rhs[0] + 1e-30 * sol[0]
        r1, sol = last
        *_, res = K_.kkt_residual(qp, ones, ones, mask, r1, *rhs[1:], *sol)
        print(f"[1] link {tag}: {statistics.median(link_ms):.3f} ms "
              f"(factor {statistics.median(fac_ms):.3f}, solve "
              f"{statistics.median(sol_ms):.3f}; median of {REPS}), "
              f"residual {float(res):.2e}")


class LayerTimers:
    """Synchronizing host timers around methods; each label's time
    excludes the time of the timed methods it calls."""

    def __init__(self, device):
        self.device = device
        self.excl = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._stack = []
        self._saved = []

    def wrap(self, cls, name, label):
        fn = getattr(cls, name)
        self._saved.append((cls, name, fn))

        def timed(*a, **kw):
            sync(self.device)
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync(self.device)
                dt = time.perf_counter() - t0
                child = self._stack.pop()
                self.excl[label] += dt - child
                self.calls[label] += 1
                if self._stack:
                    self._stack[-1] += dt

        setattr(cls, name, timed)

    def restore(self):
        for cls, name, fn in reversed(self._saved):
            setattr(cls, name, fn)
        self._saved.clear()


def scenario_solve(n, device):
    """One batched solve of BASELINE config 5 on ``n`` scenarios (see the
    module doc): (a record with the batch's loop steps as its IP
    iterations, a summary of the verdicts)."""
    prg = PrgDID(kmax=60, device=device)
    vb = scenarios.batched_qp(prg, prg.setup(), n, scale=1e-3, seed=0)
    Qb = (1e-2 * torch.eye(prg.nv, dtype=torch.float64, device=prg.device)
          ).expand(n, prg.K + 1, prg.nv, prg.nv)
    slv = Mehrotra(backend=PartitionedKKT(L=20), eps=1e-9)
    st, viol = scenarios.make_scenario_solve(prg, slv,
                                             presolve_tau=0.02)(vb, Qb)
    its = st.iter.tolist()
    n_opt = st.result.tolist().count(0)
    return (types.SimpleNamespace(iter="-", qp_iters_total=max(its)),
            f"{n_opt}/{n} optimal, {sum(its)} scenario IP iterations, "
            f"largest original-row violation {float(viol.max()):.4e}")


#: DynamicOpt's keywords of the SFunctionOpt problem (chip_smoke.py's
#: SFunctionOpt-1000 at K = 1000): the soft-constraint problem of
#: tests/test_formulations.py:61-73 with u_order = 1 and a linear weight on
#: the soft row (slack controls)
SFUNCTION_OPT = dict(x0=[1.0, 0.0], u_weight2=[0.01], yf_ref=[-1.0, 0.0],
                     yf_weight2=[100.0, 100.0],
                     y_soft_max=[float("inf"), 0.05], s_quad=1e4,
                     u_order=1, s_lin=[0.0, 50.0])


def sfunction_opt(kmax, device):
    """SqpPowell over DynamicOpt of the hosted sfun_dic (mass 1) at K =
    kmax with the keywords SFUNCTION_OPT."""
    model = hosted.HostedModel(SFunction(demo_sfunction_path("sfun_dic"),
                                         params=[[1.0]]))
    prg = DynamicOpt(model, K=kmax, **SFUNCTION_OPT, device=device)
    return SqpPowell(prg, max_iters=60)


def solve_once(kmax, device, program="DID"):
    """One init/simulate/solve: DID (also DIDMex and SpSCdist) at the
    recorded reference runs' qp_eps = 1e-7 (ROADMAP Q3 R7), Crane at the
    defaults, LQBlend as solve_generated runs it (n = kmax); SFunctionOpt
    by init/solve; or one scenario batch."""
    if program == "Scenarios256":
        return scenario_solve(kmax, device)
    if program == "SFunctionOpt":
        s = sfunction_opt(kmax, device)
        s.init()
        return s, s.solve()
    if program in ("Crane", "CraneDopri5"):
        it = integrators.Dopri5() if program == "CraneDopri5" else None
        s = SqpPowell(PrgCrane(K=kmax, integrator=it, device=device),
                      max_iters=100)
    elif program == "LQBlend":
        s = generated_solver("lqblend", n=kmax, device=device)
    elif program == "DIDMex":
        s = SqpPowell(PrgDIDMex(kmax=kmax, device=device), max_iters=50,
                      qp_eps=1e-7)
    elif program == "SpSCdist":
        distributed.init_distributed(world_size=1, device=device)
        be = ShardedPartitionedKKT(distributed.global_mesh(("sp",)))
        s = SqpPowell(PrgDID(kmax=kmax, device=device), kkt_backend=be,
                      max_iters=50, qp_eps=1e-7)
    else:
        s = SqpPowell(PrgDID(kmax=kmax, device=device), max_iters=50,
                      qp_eps=1e-7)
    s.init()
    s.simulate()
    return s, s.solve()


def layer_split(kmax, device, program):
    dev = torch.device(device)
    solve_once(kmax, device, program)                # warm-up
    lt = LayerTimers(dev)
    if program == "LQBlend":
        lt.wrap(Nlp, "make_qp", "make_qp")
        lt.wrap(Nlp, "update_fbd_qp", "update_fbd_qp")
        lt.wrap(Nlp, "eval_hess_blocks", "exact Hessian (torch.func)")
        lt.wrap(hessian.Gerschgorin, "update", "hela update (excl. Hessian)")
        be = sparse_host.SparseCallbackKKT
        lt.wrap(sparse_host._HostKKT, "prepare", "Q, C, A to the host")
        lt.wrap(be, "factor", "KKT factor (barrier data to the host)")
        lt.wrap(be, "_host_factor", "host saddle assembly + LDL' factor")
        lt.wrap(be, "solve", "KKT solve (device: reduce, recover, refine)")
        lt.wrap(sparse_host._HostKKT, "_solve_host",
                "rhs to the host, solution to the device")
        lt.wrap(be, "_host_solve", "host LDL' solves")
    elif program == "Scenarios256":
        lt.wrap(Docp, "make_qp_batch", "make_qp (batched, torch.func.vmap)")
        lt.wrap(scenarios, "merge_parallel_rows", "presolve")
        lt.wrap(scenarios, "original_row_violation", "original-row violation")
        lt.wrap(PartitionedKKT, "factor", "KKT factor")
        lt.wrap(PartitionedKKT, "solve", "KKT solve")
    else:
        if program in ("SFunctionOpt", "DIDMex"):
            lt.wrap(hosted._HostFn, "run", "hosted callbacks")
        if program == "SpSCdist":
            lt.wrap(ShardedPartitionedKKT, "factor", "KKT factor")
            lt.wrap(ShardedPartitionedKKT, "solve", "KKT solve")
            lt.wrap(ShardedPartitionedKKT, "_all_reduce",
                    "collectives (all_reduce)")
        if program == "CraneDopri5":
            lt.wrap(integrators._Loop, "run", "integrator loop (values)")
            lt.wrap(integrators._Loop, "run_jac",
                    "integrator loop (Jacobians)")
        lt.wrap(Docp, "simulate", "simulate")
        lt.wrap(Docp, "make_qp", "make_qp")
        lt.wrap(Docp, "update_fbd_qp", "update_fbd_qp")
        lt.wrap(PartitionedKKT, "factor", "KKT factor")
        lt.wrap(PartitionedKKT, "solve", "KKT solve")
    lt.wrap(Mehrotra, "cold_start", "IP cold start (excl. KKT)")
    lt.wrap(Mehrotra, "step", "IP step (excl. KKT)")
    loop = {"make_qp": 0, "iters": 0, "reads": 0}
    make_qp = Docp.make_qp

    def counted(prg, *a, **kw):
        i, r = integrators.LOOP_ITERS, integrators.LOOP_READS
        out = make_qp(prg, *a, **kw)
        loop["make_qp"] += 1
        loop["iters"] += integrators.LOOP_ITERS - i
        loop["reads"] += integrators.LOOP_READS - r
        return out

    Docp.make_qp = counted
    sync(dev)
    host_sync.COUNT = 0
    integrators.LOOP_ITERS = integrators.LOOP_READS = 0
    t0 = time.perf_counter()
    try:
        s, res = solve_once(kmax, device, program)
        sync(dev)
    finally:
        Docp.make_qp = make_qp
        lt.restore()
    wall = (time.perf_counter() - t0) * 1e3
    ip = s.qp_iters_total
    print(f"[2] warm solve: {res}, {wall:.1f} ms wall, SQP {s.iter}, IP "
          f"{ip}, host syncs {host_sync.COUNT / max(ip, 1):.2f} per IP "
          f"iteration")
    if integrators.LOOP_ITERS:
        n = max(loop["make_qp"], 1)
        print(f"[2]   adaptive loop: {loop['iters'] / n:.1f} iterations and "
              f"{loop['reads'] / n:.1f} host reads per make_qp "
              f"({loop['make_qp']} make_qp); {integrators.LOOP_ITERS} "
              f"iterations and {integrators.LOOP_READS} reads in all")
    for label, secs in sorted(lt.excl.items(), key=lambda kv: -kv[1]):
        n = lt.calls[label]
        print(f"[2]   {label}: {secs * 1e3:.1f} ms in {n} calls "
              f"({secs * 1e3 / n:.2f} ms each)")
    rest = wall - 1e3 * sum(lt.excl.values())
    print(f"[2]   rest (SQP, BFGS, setup): {rest:.1f} ms")


def device_trace(kmax, device, program, top=12):
    from torch.profiler import ProfilerActivity, profile

    solve_once(kmax, device, program)                # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s, res = solve_once(kmax, device, program)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                                # union of intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ip = max(s.qp_iters_total, 1)
    print(f"[3] traced warm solve: {res}; device busy {busy / 1e3:.1f} ms "
          f"of {wall_us / 1e3:.1f} ms, idle {100 * (1 - busy / wall_us):.1f}%"
          f"; {len(kern)} device events, {len(kern) / ip:.0f} per IP "
          f"iteration")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        print(f"[3]   {us / 1e3:9.2f} ms {100 * us / max(busy, 1):5.1f}% "
              f"{n:7d}x {name[:90]}")
    for tag, key in (("K1", "gj_interior_kernel"),
                     ("K1 large", "gj_cluster_kernel"),
                     ("K2", "thomas_kernel")):
        us = sum(v[0] for k, v in by_name.items() if key in k)
        n = sum(v[1] for k, v in by_name.items() if key in k)
        print(f"[3]   {tag}: {us / 1e3:.2f} ms in {n} launches, "
              f"{us / max(n, 1) / 1e3:.4f} ms per launch, "
              f"{100 * us / max(busy, 1):.1f}% of the device time")


def default_eps(kmax, device):
    t0 = time.perf_counter()
    s = SqpPowell(PrgDID(kmax=kmax, device=device), max_iters=50)
    s.init()
    s.simulate()
    try:
        res = s.solve()
    except SqpError as e:
        res = f"SqpError({e.reason!r})"
    st, mask = s.ip_state, s.qp.ineq_mask()
    mu = float(mk.inner(st.z, st.w, mask) / mk.count(mask))
    print(f"[4] qp_eps={s.qp_solver.eps:g}: {res}, f = {float(s.f)!r}, SQP "
          f"{s.iter}, IP {s.qp_iters_total} (last QP {s.qp_iters_last}), "
          f"z'w/m = {mu:.3g}, {time.perf_counter() - t0:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program",
                    choices=("DID", "Crane", "CraneDopri5", "LQBlend",
                             "Scenarios256", "SFunctionOpt", "DIDMex",
                             "SpSCdist"),
                    default="DID")
    ap.add_argument("--kmax", type=int, default=None,
                    help="stages (default 1000 for DID, SFunctionOpt, "
                    "DIDMex and SpSCdist, 50 for Crane and CraneDopri5), "
                    "LQBlend's n (default 2000), or the scenarios of the "
                    "batch (default 256)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    did = args.program == "DID"
    kmax = args.kmax or {"DID": 1000, "Crane": 50, "CraneDopri5": 50,
                         "LQBlend": 2000,
                         "Scenarios256": 256,
                         "SFunctionOpt": 1000, "DIDMex": 1000,
                         "SpSCdist": 1000}[args.program]
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    if did:
        chained_links(kmax, args.device)
    layer_split(kmax, args.device, args.program)
    if args.device == "cuda":
        device_trace(kmax, args.device, args.program)
    if did:
        default_eps(kmax, args.device)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
