"""Scenario batches: whole QP solves over a leading batch axis.

Port of the scenario half of ``hqp_tpu/parallel/scenarios.py`` (BASELINE
config 5: 256 perturbed DID instances, each QP solved to completion).  The
reference vmaps one problem's ``make_qp`` and solver over the batch; here
the program builds the batched StageQP by ``torch.func.vmap``
(:meth:`~hqp_tpu_torch.docp.program.Docp.make_qp_batch`) and the solver
takes the batch natively: one host loop over the whole batch, each
scenario frozen at its own result, with every partition interior of the
batch in one K1 launch per factorization and every master in one K2
launch per master solve (:mod:`hqp_tpu_torch.qp.kkt_partitioned`).
:func:`batched_safe` rebinds a solver to the reference's batch choices
(CR master, library inverse) for a caller who wants them; the port's own
batch does not call it, since its kernels take the batch as it is.  The
mesh half (``make_mesh``, ``shard_batch``) runs
over ``torch.distributed`` (:mod:`hqp_tpu_torch.parallel.distributed`):
each rank keeps its slice of the batch's leading axis as a plain tensor on
its own device and solves it; ``gather_batch`` puts the rows back together
on every rank.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from hqp_tpu_torch.parallel.distributed import (mesh_device_type,
                                                near_square, need_group)
from hqp_tpu_torch.qp.presolve import (merge_parallel_rows,
                                       original_row_violation)
from hqp_tpu_torch.utils import log


def make_mesh(n_devices=None, axes=("dp",)):
    """A device mesh over the first ``n_devices`` ranks (all by default);
    two axes split them into near-square factors.  Every rank of the
    group makes the call (a mesh makes its process groups collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    need_group()
    n = n_devices or dist.get_world_size()
    shape = (n,) if len(axes) == 1 else (near_square(n),
                                          n // near_square(n))
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def shard_batch(tree, mesh, axis_name="dp"):
    """This rank's slice of a batched tree's leading axis, on the mesh's
    device: rank i of the axis's n keeps rows [i B/n, (i+1) B/n).  B must
    divide evenly, as a sharded placement in the reference requires."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis_name)]
    i = mesh.get_local_rank(axis_name)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def part(a):
        if a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} does not split over "
                             f"{n} ranks of '{axis_name}'")
        b = a.shape[0] // n
        return a[i * b:(i + 1) * b].to(dev)

    return tree_map(part, tree)


def gather_batch(tree, mesh, axis_name="dp"):
    """The inverse of :func:`shard_batch`: every rank's slice put back in
    rank order, on every rank (one all_reduce per leaf of the zero-padded
    whole; a leaf's dtype must be one the backend sums)."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis_name)]
    i = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)

    def whole(a):
        b = a.shape[0]
        out = a.new_zeros((n * b,) + tuple(a.shape[1:]))
        out[i * b:(i + 1) * b] = a
        dist.all_reduce(out, group=group)
        return out

    return tree_map(whole, tree)


def batched_qp(prg, base_v, n_scenarios, scale=1e-3, generator=None, seed=0):
    """``n_scenarios`` perturbed copies of the iterate ``base_v``:
    base_v + scale * N(0, 1), drawn in float64 on the CPU from
    ``generator`` (a ``torch.Generator`` seeded with ``seed`` if None), so
    that every host draws the same batch, then moved to the program's
    device."""
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(seed)
    noise = scale * torch.randn((n_scenarios,) + tuple(base_v.shape),
                                generator=generator, dtype=torch.float64)
    return base_v[None] + noise.to(base_v.device)


def batched_safe(solver):
    """The solver with its KKT backend rebound to the reference's
    batched choices (``master="cr"``, ``gj="xla"``), each only where the
    caller left it unset (None); the solver itself if its backend has
    neither knob or both are set.

    The reference needs this at every vmap seam, because a vmapped Pallas
    kernel serializes the batch in its grid.  The port does not:
    :func:`make_scenario_solve` leaves the backend as it is, so a batch
    takes all its B*P interiors in one K1 launch (768 interiors of the
    256-scenario batch, PERF.md section 5) and its B masters in one K2
    launch; call this only to reproduce the reference's choices."""
    be = getattr(solver, "backend", None)
    if be is None or not hasattr(be, "master") or not hasattr(be, "gj") \
            or (be.master is not None and be.gj is not None):
        return solver
    nb = copy.copy(be)
    nb.master = nb.master or "cr"
    nb.gj = nb.gj or "xla"
    return solver.with_backend(nb)


def make_scenario_init(prg, solver):
    """(v [B, K1, nv], Q [B, K1, nv, nv]) -> the cold-started states of
    every scenario's QP."""

    def init(v, Q):
        _, qp = prg.make_qp_batch(v, Q)
        return solver.cold_start(qp, solver.init_state(qp))

    return init


def make_scenario_step(prg, solver):
    """(v, Q, states) -> one interior-point step of every scenario (each
    takes its own branch; none is frozen)."""

    def step(v, Q, states):
        _, qp = prg.make_qp_batch(v, Q)
        return solver.step(qp, states)

    return step


def make_scenario_solve(prg, solver, presolve_tau=None):
    """(v, Q) -> (states, violations): every scenario's QP solved to
    completion (cold start, then the loop to each scenario's own end:
    ``solver.solve_device``).

    ``presolve_tau``: merge tau-parallel general rows into box bounds
    first (:func:`~hqp_tpu_torch.qp.presolve.merge_parallel_rows`); the
    states then solve the PRESOLVED QPs, and ``violations`` [B] holds the
    largest violation of each scenario's original rows at its solution
    (None without a presolve).  The solver's backend is used as it is
    (no :func:`batched_safe`): every interior of the batch goes through
    one K1 launch and every master through one K2 launch.  Each call is
    the span ``scenarios.solve``, the root of the batch's spans."""

    @log.spanned("scenarios.solve")
    def solve(v, Q):
        _, qp = prg.make_qp_batch(v, Q)
        qps = qp if presolve_tau is None else \
            merge_parallel_rows(qp, presolve_tau)
        st = solver.solve_device(qps, solver.init_state(qps))
        viol = None if presolve_tau is None else \
            original_row_violation(qp, st.x)
        return st, viol

    return solve
