"""The plain reference: DID's QP from its equations, the presolve and the
certificate, against hand-built cases and the program."""

import math

import pytest
import torch

from portbench.reference import did, stageqp

INF = math.inf
F64 = dict(dtype=torch.float64)


def test_did_qp_by_hand_k2():
    """K = 2 (dt = 1/2) at the base iterate, every field written out."""
    cfg = {"kmax": 2, "with_cns": True}
    v = did.base_iterate(cfg, "cpu")
    assert torch.equal(v, torch.tensor([[1.0, 0, -2], [1, 0, -2],
                                        [-1, 0, 0]], **F64))
    Q = torch.eye(3, **F64).expand(3, 3, 3)
    qp = did.build_qp(cfg, v, Q)
    A = torch.tensor([[1.0, 0, 0.5], [0.5, 1, 0.125]], **F64)
    assert torch.equal(qp["A"], A.expand(2, 2, 3))
    # f(v_0) = (1 - 1, 0.5 - 0.25) = (0, 0.25); f(v_1) the same
    assert torch.equal(qp["b"], torch.tensor([[-1.0, 0.25], [1, 0.25]],
                                             **F64))
    assert torch.equal(qp["c"], torch.tensor([[0.0, 0, -2], [0, 0, -2],
                                              [0, 0, 0]], **F64))
    assert torch.equal(qp["C"], torch.tensor([[0.25, 1, 0]], **F64)
                       .expand(3, 1, 3))
    assert torch.equal(qp["d_up"], torch.tensor([[0.01 - 0.25],
                                                 [0.01 - 0.25], [INF]],
                                                **F64))
    assert torch.equal(qp["d_lo"], torch.full((3, 1), -INF, **F64))
    assert torch.equal(qp["var_mask"], torch.tensor(
        [[False, False, True], [True, True, True], [True, True, False]]))
    assert torch.equal(qp["con_mask"], torch.tensor([[True], [True],
                                                     [False]]))
    assert torch.equal(qp["lb"], torch.tensor([[-INF, -INF, -INF],
                                               [-INF, -INF, -INF],
                                               [0, 0, -INF]], **F64))
    assert torch.equal(qp["ub"], torch.tensor([[INF, INF, INF],
                                               [INF, 0.01, INF],
                                               [0, 0, INF]], **F64))


def field_gap(mine, ref):
    """The largest relative gap between two QPs' fields: per field, the
    largest |difference| over the finite entries over the field's largest
    |entry|; inf where a mask, an infinite entry or a shape differs."""
    worst = 0.0
    for key, r in ref.items():
        p = mine[key]
        if p.shape != r.shape:
            return float("inf")
        if r.dtype == torch.bool:
            if not torch.equal(p, r):
                return float("inf")
            continue
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(p)) or \
                not torch.equal(r[~fin], p[~fin]):
            return float("inf")
        if not fin.any():
            continue
        d = float((p[fin] - r[fin]).abs().max())
        s = float(r[fin].abs().max())
        worst = max(worst, d / s if s > 0 else d)
    return worst


def _draw(K, seed, batch=0):
    cfg = {"kmax": K, "with_cns": True}
    g = torch.Generator().manual_seed(seed)
    base = did.base_iterate(cfg, "cpu")
    shape = ((batch,) if batch else ()) + tuple(base.shape)
    v = base + 1e-3 * torch.randn(shape, generator=g, **F64)
    Q = 1e-2 * torch.eye(3, **F64).expand(shape + (3,))
    return cfg, v, Q


@pytest.mark.parametrize("K,batch", [(2, 0), (40, 0), (60, 3)])
def test_did_qp_matches_the_program(K, batch):
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.qp import presolve
    cfg, v, Q = _draw(K, 1, batch)
    prg = PrgDID(kmax=K, device="cpu")
    prg.setup()
    _, qp = prg.make_qp_batch(v, Q) if batch else prg.make_qp(v, Q)
    keys = ("Q", "c", "A", "b", "lb", "ub", "C", "d_lo", "d_up",
            "var_mask", "con_mask")
    ref = did.build_qp(cfg, v, Q)
    mine = {k: getattr(qp, k) for k in keys}
    assert field_gap(mine, ref) <= 1e-15
    merged = presolve.merge_parallel_rows(qp, 0.02)
    assert field_gap({k: getattr(merged, k) for k in keys},
                     stageqp.presolve(ref, 0.02)) <= 1e-15


def test_presolve_folds_the_path_row():
    cfg, v, Q = _draw(40, 2)
    qp = did.build_qp(cfg, v, Q)
    ps = stageqp.presolve(qp, 0.02)
    # the path row x1 + dt/2 x0 <= 0.01 (off-axis mass dt/2 <= 0.02) is
    # folded into x1's bound on stages 1..K-1 and dropped everywhere
    assert torch.isinf(ps["d_up"]).all()
    want = torch.minimum(qp["ub"][1:40, 1], qp["d_up"][1:40, 0])
    assert torch.equal(ps["ub"][1:40, 1], want)
    # a tau below dt/2 merges nothing
    assert torch.equal(stageqp.presolve(qp, 1e-3)["d_up"], qp["d_up"])


def _tiny():
    """min 1/2 (x0^2 + u0^2 + x1^2) s.t. x0 + u0 - x1 + 1 = 0, u0 <= 10:
    x = (-1/3, -1/3, 1/3), y = -1/3, the bound inactive."""
    qp = dict(Q=torch.eye(2, **F64).expand(2, 2, 2),
              c=torch.zeros(2, 2, **F64),
              A=torch.tensor([[[1.0, 1.0]]], **F64),
              b=torch.tensor([[1.0]], **F64),
              lb=torch.tensor([[-INF, -INF], [-INF, -INF]], **F64),
              ub=torch.tensor([[INF, 10.0], [INF, INF]], **F64),
              C=torch.zeros(2, 1, 2, **F64),
              d_lo=torch.full((2, 1), -INF, **F64),
              d_up=torch.full((2, 1), INF, **F64),
              var_mask=torch.tensor([[True, True], [True, False]]),
              con_mask=torch.zeros(2, 1, dtype=torch.bool))
    t = 1.0 / 3.0
    x = torch.tensor([[-t, -t], [t, 0.0]], **F64)
    y = {"dyn": torch.tensor([[-t]], **F64), "fix": torch.zeros(2, 2, **F64)}
    z = {k: torch.zeros(2, n, **F64) for k, n in (("bl", 2), ("bu", 2),
                                                   ("gl", 1), ("gu", 1))}
    w = {k: torch.ones(2, n, **F64) for k, n in (("bl", 2), ("bu", 2),
                                                  ("gl", 1), ("gu", 1))}
    w["bu"][0, 1] = 10.0 + t
    return qp, x, y, z, w


def test_certificate_of_a_hand_solved_qp():
    qp, x, y, z, w = _tiny()
    primal, dual, mu = stageqp.certificate(qp, x, y, z, w)
    assert float(primal) <= 1e-16 and float(dual) <= 1e-16
    assert float(mu) == 0.0
    assert float(stageqp.norm_data(qp, 0)) == 10.0


@pytest.mark.parametrize("what,expect", [("x", (1e-4, 1e-4)),
                                         ("y", (0.0, 1e-4)),
                                         ("w", (1e-4, 0.0))])
def test_certificate_sees_a_moved_answer(what, expect):
    qp, x, y, z, w = _tiny()
    if what == "x":
        x = x.clone()
        x[0, 0] += 1e-3
    elif what == "y":
        y = dict(y, dyn=y["dyn"] + 1e-3)
    else:
        w = dict(w, bu=w["bu"] + 1e-3)
    primal, dual, _ = stageqp.certificate(qp, x, y, z, w)
    assert float(primal) == pytest.approx(expect[0], abs=1e-12)
    assert float(dual) == pytest.approx(expect[1], abs=1e-12)


def test_certificate_of_the_programs_solution():
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.qp import presolve
    from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
    from hqp_tpu_torch.qp.mehrotra import OPTIMAL, Mehrotra
    cfg, v, Q = _draw(60, 3)
    prg = PrgDID(kmax=60, device="cpu")
    prg.setup()
    _, qp = prg.make_qp(v, Q)
    qps = presolve.merge_parallel_rows(qp, 0.02)
    slv = Mehrotra(PartitionedKKT(L=20), eps=1e-9)
    st = slv.solve(qps, slv.init_state(qps))
    assert int(st.result) == OPTIMAL
    groups = ("bl", "bu", "gl", "gu")
    ref = stageqp.presolve(did.build_qp(cfg, v, Q), 0.02)
    primal, dual, mu = stageqp.certificate(
        ref, st.x, dict(st.y), {g: getattr(st.z, g) for g in groups},
        {g: getattr(st.w, g) for g in groups})
    assert float(primal) <= 1e-9 and float(dual) <= 1e-9
    assert float(mu) <= 1e-9
    # the original rows at the solution, as the program measures them
    assert float(stageqp.row_violation(did.build_qp(cfg, v, Q), st.x)) == \
        float(presolve.original_row_violation(qp, st.x))
