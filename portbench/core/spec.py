"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix; the configuration is
``portbench/configs/<config>.json``, the traffic mix
``portbench/traffic/<traffic>.json``, each per-layer metric
``portbench/metrics/<metric>.py`` and each configuration's plain
reference ``portbench/reference/<reference>.py``.  A new cell, mix,
configuration or metric is a new file; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _module(path, name):
    """Import the Python file at ``path`` under ``name`` (a metric's name
    may hold dots, so files are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    chips: int
    config: dict         # portbench/configs/<config>.json
    traffic: dict        # portbench/traffic/<traffic>.json
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, bench=None, pkg=PKG):
    """The cell ``name`` of BENCHMARK.json; raises KeyError if it has
    none."""
    bench = bench if bench is not None else benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(work))})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = dict(_json(os.path.join(os.path.dirname(pkg),
                                  configs[w["config"]]["file"])))
    traffic = dict(_json(os.path.join(pkg, "traffic",
                                      w["traffic"] + ".json")))
    traffic.setdefault("name", w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reference(cfg, pkg=PKG):
    """The configuration's plain reference module."""
    name = cfg["reference"]
    return _module(os.path.join(pkg, "reference", name + ".py"),
                   f"portbench.reference.{name}")


def metric_reader(name, pkg=PKG):
    """The ``read(ctx)`` function of a per-layer metric."""
    return _module(os.path.join(pkg, "metrics", name + ".py"),
                   f"portbench.metrics.{name}").read


def metric_data(name, pkg=PKG):
    """A metric's own data file ``portbench/metrics/<name>.json``."""
    return _json(os.path.join(pkg, "metrics", name + ".json"))
