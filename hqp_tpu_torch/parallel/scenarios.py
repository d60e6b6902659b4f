"""Scenario batches: whole QP solves over a leading batch axis.

Port of the scenario half of ``hqp_tpu/parallel/scenarios.py`` (BASELINE
config 5: 256 perturbed DID instances, each QP solved to completion).  The
reference vmaps one problem's ``make_qp`` and solver over the batch; here
the program builds the batched StageQP by ``torch.func.vmap``
(:meth:`~hqp_tpu_torch.docp.program.Docp.make_qp_batch`) and the solver
takes the batch natively: one host loop over the whole batch, each
scenario frozen at its own result, with every partition interior of the
batch in one K1 launch per factorization and every master in one K2
launch per master solve (:mod:`hqp_tpu_torch.qp.kkt_partitioned`).  The
reference's ``batched_safe`` has no counterpart: the port's kernels take
the batch as it is.  The device mesh (``make_mesh``, ``shard_batch``)
belongs to the sharding slice.
"""

from __future__ import annotations

import torch

from hqp_tpu_torch.qp.presolve import (merge_parallel_rows,
                                       original_row_violation)


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
    (None without a presolve)."""

    def solve(v, Q):
        _, qp = prg.make_qp_batch(v, Q)
        qps = qp if presolve_tau is None else \
            merge_parallel_rows(qp, presolve_tau)
        st = solver.solve_device(qps, solver.init_state(qps))
        viol = None if presolve_tau is None else \
            original_row_violation(qp, st.x)
        return st, viol

    return solve
