"""The program's own spans as the benchmark reads them: device time by the
span that launched it, idle time by the innermost range when the
program's spans join the benchmark's labels, the refinement counters'
reader, and the spans tool at a tiny size on the CPU."""

import pytest
import torch

from portbench import run as bench_run
from portbench.core import progspans, spec, trace

MS = 1_000_000


def test_device_time_goes_to_every_span_open_at_launch():
    """Nested spans: an op counts for the innermost span and those around
    it; the launch decides, even when the op runs after its span closed;
    ops launched outside every span go to 'host', ops with no launch to
    'unlinked'."""
    spans = [("mehrotra.solve", 0, 100 * MS),
             ("partitioned.solve", 10 * MS, 40 * MS),
             ("kkt.refine", 20 * MS, 30 * MS),
             ("partitioned.factor", 50 * MS, 60 * MS)]
    ops = [("k_a", 12 * MS, 14 * MS, 11 * MS),       # partitioned.solve
           ("k_b", 45 * MS, 48 * MS, 25 * MS),       # kkt.refine, run late
           ("k_c", 55 * MS, 56 * MS, 51 * MS),       # partitioned.factor
           ("k_d", 101 * MS, 102 * MS, 100.5 * MS),  # after every span
           ("k_e", 5 * MS, 9 * MS, None)]            # no launch found
    dev = progspans.device_by_span(spans, ops)
    assert dev["kkt.refine"] == pytest.approx(3e-3)
    assert dev["partitioned.solve"] == pytest.approx(2e-3 + 3e-3)
    assert dev["partitioned.factor"] == pytest.approx(1e-3)
    assert dev["mehrotra.solve"] == pytest.approx(2e-3 + 3e-3 + 1e-3)
    assert dev["host"] == pytest.approx(1e-3)
    assert dev["unlinked"] == pytest.approx(4e-3)
    assert progspans.device_by_span(spans, []) == {}


def test_idle_goes_to_the_innermost_program_span():
    """The program's spans among the labels: an idle stretch inside one is
    its; where none is open the benchmark's own label keeps it."""
    events = [(False, "window", 0, 100 * MS), (False, "unit", 0, 100 * MS),
              (False, "ip", 0, 90 * MS),
              (False, "mehrotra.step_length", 10 * MS, 30 * MS),
              (False, "kkt.refine.round", 50 * MS, 60 * MS),
              (True, "k", 0, 10 * MS), (True, "k", 30 * MS, 50 * MS),
              (True, "k", 60 * MS, 95 * MS)]
    names = ("mehrotra.step_length", "kkt.refine.round")
    tr = trace.reduce(events, bench_run.LABELS + names)
    assert tr.idle_by_label["mehrotra.step_length"] == pytest.approx(0.02)
    assert tr.idle_by_label["kkt.refine.round"] == pytest.approx(0.01)
    assert tr.idle_by_label["unit"] == pytest.approx(0.005)
    assert "ip" not in tr.idle_by_label
    old = trace.reduce(events, bench_run.LABELS)
    assert old.idle_by_label == {"ip": pytest.approx(0.03),
                                 "unit": pytest.approx(0.005)}


def test_refine_reader_reads_the_counters_or_nothing(monkeypatch):
    from hqp_tpu_torch.qp import kkt

    read = spec.metric_reader("refine_rounds_per_solve")
    monkeypatch.setattr(kkt, "REFINE_CALLS", 40)
    monkeypatch.setattr(kkt, "REFINE_ROUNDS", 50)
    assert read({}) == pytest.approx(1.25)
    monkeypatch.setattr(kkt, "REFINE_CALLS", 0)
    assert read({}) is None
    monkeypatch.delattr(kkt, "REFINE_ROUNDS")
    monkeypatch.delattr(kkt, "REFINE_CALLS")
    assert read({}) is None


def test_launch_events_reads_the_program_spans_of_a_trace():
    from hqp_tpu_torch.utils import log

    log.timers.reset()
    log.set_tracing(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with log.timers.span("mehrotra.solve"):
                with log.timers.span("kkt.refine"):
                    torch.ones(4).sum()
            with torch.profiler.record_function("unit"):
                pass
    finally:
        log.set_tracing(False)
    spans, ops = progspans.launch_events(prof, ("mehrotra.solve",
                                                "kkt.refine"))
    assert [n for n, _, _ in sorted(spans, key=lambda s: s[1])] == \
        [r.name for r in log.timers.records]
    assert all(a <= b for _, a, b in spans) and ops == []
    log.timers.reset()


def test_spans_tool_on_the_cpu():
    """The tool end to end at B = 4 on the CPU: no device, so no device
    readings; the counters, the host's waits and the bit-for-bit check
    are there."""
    from portbench.tools import spans

    res = spans.measure("did60_scen.montecarlo", 2 ** 31 + 5, device="cpu",
                        overrides={"batch": 4})
    m = res["metrics"]
    assert m["refine_rounds_per_solve"] > 0
    assert 0 < m["host_wait_share"] <= 100
    assert m["kkt_solve_dev_ms_per_ip"] is None
    assert res["bit_identical"] and res["repeatable"]
    assert len(res["unit_s"]) == 6 and min(res["steps"]) > 0
    assert res["unit4"]["mehrotra.solve"]["calls"] == 1
