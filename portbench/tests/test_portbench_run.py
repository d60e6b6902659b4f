"""A run on the CPU at a tiny size (B = 8): the last line, the
refusals, the lookup by name and the imports."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import run as bench_run
from portbench.core import spec

TINY = {"did60_scen.montecarlo": {"batch": 8}}


def tiny_run(workload, seed=2 ** 31 + 11, trace=False, **kw):
    return bench_run.run(workload, seed, 0.5, trace, device="cpu",
                         overrides=TINY[workload], require_chip=False,
                         t_start=time.perf_counter(), **kw)


@pytest.fixture(scope="module", params=sorted(TINY))
def traced(request):
    return request.param, tiny_run(request.param, trace=True)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_run_is_correct_with_its_end_to_end_metrics(workload):
    res = tiny_run(workload)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    cell = spec.load_cell(workload)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    for name, n in res["check"].items():
        assert n["value"] <= n["limit"], name
    json.loads(json.dumps(bench_run._finite(res), allow_nan=False))


def test_traced_run_reports_its_span_and_counter_metrics(traced):
    workload, res = traced
    assert res["correct"]
    # on a CPU host the device's metrics find nothing to read and are
    # left out; the spans and counters are there
    assert {"qp_build_ms", "host_syncs_per_ip", "kkt_factor_ms_per_ip",
            "kkt_solve_ms_per_ip"} <= set(res["metrics"])
    assert not {"device_idle", "k1_roofline", "k2_roofline",
                "launches_per_ip"} & set(res["metrics"])
    assert "breakdown" not in res
    assert res["window"]["units"] >= 2           # traced unit + spanned


def test_cli_refuses_without_a_card(tmp_path):
    """No card: exit code not 0 and no line on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run",
                        "--workload", "did60_scen.montecarlo", "--seed",
                        "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_cli_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no result."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench.run",
                        "--workload", "did60_scen.montecarlo", "--seed",
                        "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files are found from BENCHMARK.json's names, with no edit."""
    pkg = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        (pkg / d).mkdir(parents=True)
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps(
        {"program": "DID", "kmax": 120, "reference": "did"}))
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps(
        {"loop": "closed", "start": "cold", "scale": 0.002}))
    (pkg / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 2 * ctx['x']\n")
    bench = spec.benchmark()
    bench = dict(bench, configs=bench["configs"] + [
        {"name": "new_cfg", "source": "s", "reduced": [],
         "file": "portbench/configs/new_cfg.json", "why": "w"}],
        workloads=bench["workloads"] + [
        {"name": "new_cfg.new_mix", "config": "new_cfg",
         "traffic": "new_mix", "chips": 1, "why": "w"}],
        per_layer=bench["per_layer"] + [
        {"name": "new.metric", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "IP", "moves": "qp_per_s",
         "workloads": ["new_cfg.new_mix"]}])
    cell = spec.load_cell("new_cfg.new_mix", bench, pkg=str(pkg))
    assert cell.config["kmax"] == 120 and cell.traffic["scale"] == 0.002
    assert [m["name"] for m in cell.per_layer][-1] == "new.metric"
    assert spec.metric_reader("new.metric", pkg=str(pkg))({"x": 3}) == 6
    # the existing cells do not see the new metric
    old = spec.load_cell("did60_scen.montecarlo", bench)
    assert "new.metric" not in [m["name"] for m in old.per_layer]
    with pytest.raises(KeyError):
        spec.load_cell("no.such", bench)


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, in a fresh interpreter: no module whose
    top-level name is jax, jaxlib, flax or hqp_tpu (hqp_tpu_torch is
    the port, another top-level name)."""
    code = (
        "import portbench.run as r, portbench.tools.sweep\n"
        "import hqp_tpu_torch.all_modules\n"
        "from portbench.core import check, hooks, spec, system, traffic, "
        "trace, work\n"
        "from portbench.reference import did, stageqp\n"
        "import torch.profiler\n"
        "b = spec.benchmark()\n"
        "[spec.metric_reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "[spec.reference(spec.load_cell(w['name'], b).config) "
        "for w in b['workloads']]\n"
        "print(r.foreign_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "hqp_tpu_torch_x", types.ModuleType(
        "hqp_tpu_torch_x"))
    assert bench_run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "hqp_tpu.ops", types.ModuleType(
        "hqp_tpu.ops"))
    assert bench_run.foreign_modules() == ["hqp_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "from portbench.reference import did, stageqp\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('hqp_tpu_torch', 'hqp_tpu', 'jax')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr
