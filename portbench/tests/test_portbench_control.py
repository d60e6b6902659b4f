"""The check's control and faults: each must come out not correct.

On the CPU at a tiny size (B = 8): the control (the plain
reference's float32 QP build in the program's place, with the program's
float32 factorization) and, with the timed path broken underneath, a step
that returns its state unchanged, an answer altered where it is produced,
and half of a batch left out with the mean of the rest in its place.  On
the card (``-m card``) the control runs at each cell's own size on three
seeds and prints its readings.
"""

import dataclasses
import json

import pytest
import torch
from torch.utils._pytree import tree_map

from portbench import run as bench_run
from portbench.tests.test_portbench_run import TINY, tiny_run


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload):
    res = tiny_run(workload, control=True)
    assert not res["correct"] and res["failed"] >= 1
    over = [k for k, n in res["check"].items() if n["value"] > n["limit"]]
    assert over


@pytest.mark.parametrize("workload", sorted(TINY))
def test_step_that_returns_its_state_unchanged(workload, monkeypatch):
    """Each step hands back the iterate it was given (only the iteration
    count moves on, or the host loop would never end)."""
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    monkeypatch.setattr(Mehrotra, "step", lambda self, qp, st: dataclasses.
                        replace(st, iter=st.iter + 1))
    res = tiny_run(workload)
    assert not res["correct"]
    assert res["check"]["not_optimal"]["value"] == res["attempted"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_answer_altered_where_it_is_produced(workload, monkeypatch):
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    orig = Mehrotra.solve_device

    def altered(self, qp, state, *a, **kw):
        st = orig(self, qp, state, *a, **kw)
        x = st.x.clone()
        x[..., 5, 2] += 1e-6                     # a control of stage 5
        return dataclasses.replace(st, x=x)

    monkeypatch.setattr(Mehrotra, "solve_device", altered)
    res = tiny_run(workload)
    assert not res["correct"]
    assert res["check"]["primal"]["value"] > res["check"]["primal"]["limit"]


def test_half_of_the_batch_left_out(monkeypatch):
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    orig = Mehrotra.solve_device

    def half(self, qp, state):
        B = qp.A.shape[0]
        h = B // 2
        qh = tree_map(lambda a: a[:h], qp)
        st = orig(self, qh, self.init_state(qh))

        def fill(a):
            rest = a[:1].expand((B - h,) + a.shape[1:]) \
                if not a.is_floating_point() else \
                a.mean(0, keepdim=True).expand((B - h,) + a.shape[1:])
            return torch.cat([a, rest])

        return dataclasses.replace(st, **{
            f.name: tree_map(fill, getattr(st, f.name))
            for f in dataclasses.fields(st)})

    monkeypatch.setattr(Mehrotra, "solve_device", half)
    res = tiny_run("did60_scen.montecarlo")
    assert not res["correct"]
    assert res["failed"] >= res["attempted"] // 2 - 1


@pytest.mark.card
@pytest.mark.parametrize("workload", ["did60_scen.montecarlo"])
def test_control_at_the_cells_own_size(workload, card):
    """The control on the card at the cell's size, three seeds."""
    for seed in (9001, 9002, 9003):
        res = bench_run.run(workload, seed, 5.0, False, control=True)
        print(json.dumps({"workload": workload, "seed": seed,
                          "control": True, "attempted": res["attempted"],
                          "failed": res["failed"], "check": res["check"]}))
        assert not res["correct"]
