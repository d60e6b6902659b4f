"""The yardstick's arithmetic on fixed numbers: rooflines, sizes, the
trace reduction and the metric readers."""

import types

import pytest

from portbench.core import spec, trace, work


def test_gj_bound_at_the_batch_shape():
    # [768, 98, 98] with b = 4 in f64: 123 MB moved, 3.67e-5 s of bytes
    s, side = work.gj_bound_s(768, 98, 4)
    nbytes = 768 * (2 * 98 * 98 + 2 * 98 * 4 + 16) * 8
    assert side == "bytes" and s == pytest.approx(nbytes / 3.35e12)
    assert s == pytest.approx(3.6695269253731345e-05, rel=1e-12)


def test_gj_bound_operations_side():
    # a large interior is bound by its 2 s^3 operations
    s, side = work.gj_bound_s(1, 512, 10)
    flops = 2 * 512 ** 3 + 2 * 512 * 512 * 10 + 2 * 512 * 100
    assert side == "operations" and s == pytest.approx(flops / 67e12)


def test_thomas_bound():
    # 256 systems of N = 4 blocks of 2 x 2 (the scenario batch's masters)
    s, side = work.thomas_bound_s(4, 2, 256)
    assert side == "bytes"
    assert s == pytest.approx(2.689910447761194e-08, rel=1e-12)
    one, _ = work.thomas_bound_s(4, 2, 1)
    assert s == pytest.approx(256 * one)


@pytest.mark.parametrize("K,L,want", [(300, 20, 20), (60, 20, 20),
                                      (100000, 20, 20), (7, 20, 7),
                                      (210, 20, 15), (3, 20, 3)])
def test_choose_L(K, L, want):
    assert work.choose_L(K, 2, 1, L) == want


def test_sizes():
    z = work.sizes({"kmax": 300, "L": 20, "batch": 1}, 2, 1)
    assert z == dict(K=300, L=20, P=15, s=98, b=4, N=16, n=2, B=1)
    assert work.sizes({"kmax": 60, "L": 20, "batch": 16384}, 2, 1)["B"] \
        == 16384


def _events():
    """Window [0, 100] ns; device busy [10, 30], [20, 40], [60, 70];
    host spans: ip [0, 90] holding kkt.solve [35, 65]."""
    return [(False, "window", 0, 100), (False, "ip", 0, 90),
            (False, "kkt.solve", 35, 65), (False, "unrelated", 0, 100),
            (True, "k_a", 10, 30), (True, "k_a", 20, 40),
            (True, "k_b", 60, 70), (True, "k_c", 95, 120)]


def test_trace_reduce_busy_and_idle():
    tr = trace.reduce(_events(), ("window", "ip", "kkt.solve"))
    # union of [10, 40], [60, 70], [95, 100] (clipped at the window)
    assert tr.busy_s == pytest.approx(45e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.events == 4
    assert tr.by_name["k_a"] == [pytest.approx(40e-9), 2]
    # idle [0,10] ip, [40,60]: 40-60 in kkt.solve, [70,95]: 70-90 ip,
    # 90-95 outside every span
    idle = tr.idle_by_label
    assert idle["ip"] == pytest.approx(30e-9)
    assert idle["kkt.solve"] == pytest.approx(20e-9)
    assert idle["host"] == pytest.approx(5e-9)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert tr.top_ops(2) == [["k_a", pytest.approx(40e-9)],
                             ["k_b", pytest.approx(10e-9)]]
    assert tr.device_seconds(["k_a", "k_c"]) == (pytest.approx(45e-9), 3)


def test_trace_reduce_reads_nothing_without_device_events():
    ev = [e for e in _events() if not e[0]]
    assert trace.reduce(ev, ("window",)) is None


def _ctx(**kw):
    tr = trace.Trace(busy_s=0.25, window_s=1.0, events=6000,
                     by_name={"gj_interior_kernel<double>": [0.01, 31],
                              "thomas_kernel<double>": [0.002, 400],
                              "elementwise": [0.2, 5000]},
                     idle_by_label={"ip": 0.75})
    sp = types.SimpleNamespace(
        excl={"qp_build": 0.03, "kkt.factor": 0.3, "kkt.solve": 0.9},
        calls={"qp_build": 6, "kkt.factor": 31, "kkt.solve": 61})
    ctx = dict(config={"kmax": 300, "L": 20, "batch": 1},
               sizes=work.sizes({"kmax": 300, "L": 20, "batch": 1}, 2, 1),
               setup_s=20.0, window_s=30.0, attempted=20, failed=0,
               units=20, syncs=4000, window_ip=600,
               peak_window_bytes=3 * 2 ** 30, trace=tr, spans=sp,
               trace_units=1, span_units=3,
               trace_tally=dict(ip=30, factorizations=31, kkt_solves=61),
               span_tally=dict(ip=90, factorizations=93, kkt_solves=183))
    ctx.update(kw)
    return ctx


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_metric_readers_on_fixed_numbers():
    ctx = _ctx()
    assert _read("qp_per_s", ctx) == pytest.approx(20 / 30.0)
    assert _read("qp_per_s", _ctx(failed=5)) == pytest.approx(15 / 30.0)
    assert _read("setup_s", ctx) == 20.0
    assert _read("qp_build_ms", ctx) == pytest.approx(10.0)
    assert _read("host_syncs_per_ip", ctx) == pytest.approx(4000 / 600)
    assert _read("launches_per_ip", ctx) == pytest.approx(200.0)
    assert _read("kkt_factor_ms_per_ip", ctx) == pytest.approx(300 / 90)
    assert _read("kkt_solve_ms_per_ip", ctx) == pytest.approx(900 / 90)
    assert _read("device_idle", ctx) == pytest.approx(75.0)
    assert _read("peak_mem_gib", ctx) == pytest.approx(3.0)
    k1, _ = work.gj_bound_s(15, 98, 4)
    assert _read("k1_roofline", ctx) == pytest.approx(100 * 31 * k1 / 0.01)
    k2, _ = work.thomas_bound_s(16, 2)
    assert _read("k2_roofline", ctx) == pytest.approx(100 * 61 * k2 / 0.002)


@pytest.mark.parametrize("name", ["launches_per_ip", "device_idle",
                                  "k1_roofline", "k2_roofline"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert _read(name, _ctx(trace=None)) is None


@pytest.mark.parametrize("name", ["qp_build_ms", "kkt_factor_ms_per_ip",
                                  "kkt_solve_ms_per_ip"])
def test_span_readers_read_nothing_without_spans(name):
    assert _read(name, _ctx(spans=None)) is None


def test_roofline_reads_nothing_without_its_kernels():
    tr = trace.Trace(0.1, 1.0, 10, {"other": [0.1, 10]}, {})
    assert _read("k1_roofline", _ctx(trace=tr)) is None
