"""The crane's cell (``crane_scen.montecarlo``): its shapes, its two
per-layer readers on made-up contexts, and a run on the CPU at a tiny
batch."""

import time

import pytest

from portbench import run as bench_run
from portbench.core import spec, trace, work
from portbench.reference import crane

CELL = "crane_scen.montecarlo"
#: the kernels' names as the profiler gives them on the card
TILE = ("void (anonymous namespace)::gj_interior_kernel<double, 8>(double "
        "const*, double const*, double*, double*, double*, int, int)")
BATCHED = ("void (anonymous namespace)::gj_interior_kernel_batched<double, "
           "6, 13, 4>(double const*, double const*, double*, double*, "
           "double*, int, int)")


def _ctx(**kw):
    cfg = spec.load_cell(CELL).config
    ctx = dict(config=cfg, sizes=work.sizes(cfg, crane.NX, crane.NU),
               trace=None, trace_tally=None)
    ctx.update(kw)
    return ctx


def _trace(by_name):
    return trace.Trace(busy_s=1.0, window_s=1.0, events=1, by_name=by_name,
                       idle_by_label={})


def test_sizes_of_the_crane_configuration():
    """K 50 at L 20 takes L 10 (at least nx / nu + 1 = 7 stages): five
    interiors of 124 a QP, coupled by 12 columns, a master of six blocks
    of six."""
    z = _ctx()["sizes"]
    assert {k: z[k] for k in ("K", "L", "P", "s", "b", "N", "n")} == dict(
        K=50, L=10, P=5, s=124, b=12, N=6, n=6)
    cfg = spec.load_cell(CELL).config
    assert cfg["kmax"] == cfg["K"]


def test_tile_pattern_names_the_tile_kernel_alone():
    pats = spec.metric_data("k1_tile_roofline")["kernels"]
    assert any(p in TILE for p in pats)
    assert not any(p in BATCHED for p in pats)


def test_tile_roofline_reads_the_tile_kernel():
    """The bound of every factorization of the profiled unit over the tile
    kernel's device time; the batched kernel's time is not counted; None
    without a trace, a tally or the kernel."""
    read = spec.metric_reader("k1_tile_roofline")
    tally = dict(factorizations=10)
    assert read(_ctx()) is None
    assert read(_ctx(trace=_trace({TILE: [1.0, 2]}))) is None
    assert read(_ctx(trace=_trace({BATCHED: [1.0, 2]}),
                     trace_tally=tally)) is None
    z = _ctx()["sizes"]
    need, side = work.gj_bound_s(z["P"], z["s"], z["b"])
    assert side == "bytes"
    got = read(_ctx(trace=_trace({TILE: [0.5, 2], BATCHED: [9.0, 3]}),
                    trace_tally=tally))
    assert got == pytest.approx(100.0 * need * 10 / 0.5)


def test_integrations_per_build_reads_the_counters(monkeypatch):
    """INTEGRATIONS / QP_BUILDS; None where the program has no such
    counters (as before they were added) or built no QP."""
    from hqp_tpu_torch.docp import program as docp
    from hqp_tpu_torch.omu import program as omu

    read = spec.metric_reader("omu_integrations_per_build")
    monkeypatch.setattr(omu, "INTEGRATIONS", 6)
    monkeypatch.setattr(docp, "QP_BUILDS", 3)
    assert read(_ctx()) == 2.0
    monkeypatch.setattr(docp, "QP_BUILDS", 0)
    assert read(_ctx()) is None
    monkeypatch.setattr(docp, "QP_BUILDS", 3)
    monkeypatch.delattr(omu, "INTEGRATIONS")
    assert read(_ctx()) is None
    monkeypatch.delattr(docp, "QP_BUILDS")
    assert read(_ctx()) is None


@pytest.mark.parametrize("trace_on", [False, True])
def test_tiny_run_is_correct(trace_on, monkeypatch):
    """Two draws a unit on the CPU: correct; traced, the counter reading
    is there and the device's is left out.  The counters count from
    import, and a run is a process of its own: here they start at 0."""
    from hqp_tpu_torch.docp import program as docp
    from hqp_tpu_torch.omu import program as omu

    monkeypatch.setattr(omu, "INTEGRATIONS", 0)
    monkeypatch.setattr(docp, "QP_BUILDS", 0)
    res = bench_run.run(CELL, 2 ** 33 + 3, 0.5, trace_on, device="cpu",
                        overrides={"batch": 2}, require_chip=False,
                        t_start=time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    for name, n in res["check"].items():
        assert n["value"] <= n["limit"], name
    if trace_on:
        assert res["metrics"]["omu_integrations_per_build"]["value"] == 2.0
        assert "k1_tile_roofline" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"qp_per_s", "setup_s"}
