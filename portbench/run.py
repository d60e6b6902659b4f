"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``hqp_tpu_torch``).  Set-up builds the cell's configuration
through the port's registry, draws its inputs on the card from the seed
and runs one warm unit of work at the cell's shapes; the window then
solves unit after unit (a closed loop) until the first unit that ends
after ``--seconds``.  Once the window has closed, every QP of the window
is judged by the configuration's plain reference (``correct``), and the
last line of standard output is the result as one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a torch.profiler trace of the window's
first unit and from synchronizing spans around the program's layers in
the rest.  Each number the check compared is printed with its limit, as
the last lines on standard error and under the result's last key,
``check``.

A run refuses to start without as many CUDA cards as the cell asks for,
and refuses to print a result if the process has loaded JAX or the JAX
package (``hqp_tpu``) by the time the window closes.  Build and kernel
caches stay in ``build/`` inside the checkout.  ``--control 1`` runs the
check's control instead of the program (see
``portbench/core/system.py``); the driver's runs never do.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level module names a run may not hold once its window has closed
FOREIGN = ("jax", "jaxlib", "flax", "hqp_tpu")
#: the host-side span labels of a traced run
LABELS = ("window", "unit", "qp_build", "ip", "kkt.factor", "kkt.solve",
          "violation")
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 160


class NoChip(RuntimeError):
    pass


class ForeignModules(RuntimeError):
    pass


def foreign_modules():
    """Loaded modules whose top-level name is one of :data:`FOREIGN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def cache_dirs(root):
    """Point every compiler cache the run could reach at fixed
    directories inside the checkout."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({type(exc).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read (exit {out.returncode})"


def tally(units, outputs):
    """IP iterations of the units (a batch's steps count once each) and
    the factorizations and KKT solves their QPs needed (one of each at
    the cold start; one factorization and two solves an iteration)."""
    ip = fac = sol = 0
    hist = collections.Counter()
    for u in units:
        it = outputs(u)["iters"].reshape(-1).tolist()
        ip += max(it)
        fac += sum(i + 1 for i in it)
        sol += sum(2 * i + 1 for i in it)
        hist.update(it)
    return dict(ip=ip, factorizations=fac, kkt_solves=sol,
                iters={str(k): hist[k] for k in sorted(hist)})


def run(workload, seed, seconds, trace, *, device="cuda", overrides=None,
        control=False, bench=None, require_chip=True, t_start=T_START):
    """One run of the cell ``workload``; returns the result object."""
    import torch

    from portbench.core import check, hooks, spec, system, traffic, work
    from portbench.core import trace as trace_mod

    cell = spec.load_cell(workload, bench)
    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise NoChip(f"cell {workload} needs {cell.chips} CUDA card(s); "
                     f"this machine has "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cache_dirs(spec.ROOT)
    cfg = dict(cell.config, **(overrides or {}))
    traffic.check_traffic(cell.traffic)
    ref = spec.reference(cfg)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # -- set-up: the program, the draws, one warm unit at the cell's shapes
    t_build = time.perf_counter()
    sut = system.System(cfg, device, control=control, ref=ref)
    draws = traffic.Draws(ref.base_iterate(cfg, sut.prg.device), sut.batch,
                          cell.traffic["scale"], seed, sut.prg.device)
    sync()
    t_warm = time.perf_counter()
    sut.run(draws.next())
    sync()
    setup_s = time.perf_counter() - t_start
    setup_parts = dict(start_s=t_build - t_start, build_s=t_warm - t_build,
                       warm_s=time.perf_counter() - t_warm)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    from hqp_tpu_torch.utils import sync as host_sync
    syncs0 = host_sync.COUNT
    launches0 = sut.kernel_launches()

    # -- the window ------------------------------------------------------
    units, traced, spanned, unit_s = [], [], [], []
    tr = gaps = timers = None
    t0 = time.perf_counter()

    def one(into):
        t = time.perf_counter()
        into.append(sut.run(draws.next()))
        sync()
        unit_s.append(time.perf_counter() - t)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        # (1) one unit under a device-only trace: the device's busy time,
        # its operations and their count, at the least cost to the host
        if cuda:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                one(traced)
                torch.empty(1, device=device).fill_(0.0)   # end marker
                sync()
            dev_events = trace_mod.profiler_events(prof, ())
            del prof
        else:
            one(traced)
        # (2) one unit under a host and device trace with the layers
        # annotated: what the host was doing while the device idled
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            with hooks.Annotations(sut.span_targets()):
                with record_function("window"):
                    with record_function("unit"):
                        one(units)
        host_events = trace_mod.profiler_events(prof, LABELS)
        del prof
        # (3) the rest under synchronizing spans
        with hooks.Timers(sut.span_targets(), sync) as timers:
            while not spanned or time.perf_counter() - t0 < seconds:
                one(spanned)
        units = traced + units + spanned
    else:
        while not units or time.perf_counter() - t0 < seconds:
            one(units)
    window_s = time.perf_counter() - t0
    syncs = host_sync.COUNT - syncs0
    launches = {k: n - launches0[k]
                for k, n in sut.kernel_launches().items()}

    found = foreign_modules()
    if found:
        raise ForeignModules(f"loaded once the window closed: {found}")
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0

    # -- after the window: tallies, the trace, then the check ------------
    outputs, Q = sut.outputs(), sut.Q
    whole = tally(units, outputs)
    if trace:
        tr = trace_mod.reduce(dev_events, LABELS) if cuda else None
        gaps = trace_mod.reduce(host_events, LABELS)
    del sut, draws
    if cuda:
        torch.cuda.empty_cache()
    numbers, attempted, failed = check.judge(ref, cfg, units, outputs, Q)

    ctx = dict(config=cfg, sizes=work.sizes(cfg, ref.NX, ref.NU),
               setup_s=setup_s, window_s=window_s, attempted=attempted,
               failed=failed, units=len(units), syncs=syncs,
               window_ip=whole["ip"], peak_window_bytes=peak_window,
               trace=tr, spans=timers, trace_units=len(traced),
               span_units=len(spanned),
               trace_tally=tally(traced, outputs) if trace else None,
               span_tally=tally(spanned, outputs) if trace else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        val = spec.metric_reader(m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=cell.chips if cuda else 0,
               memory_peak_bytes=max(peak_setup, peak_window),
               power_limit=power_limit() if cuda else "",
               cuda=torch.version.cuda)
    result = dict(correct=failed == 0 and attempted > 0,
                  attempted=attempted, failed=failed, metrics=metrics,
                  device=dev)
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in tr.top_ops()],
            "idle_gaps": gaps.top_idle() if gaps is not None else []}
    result["window"] = dict(seconds=window_s, units=len(units),
                            ip_steps=whole["ip"], iters=whole["iters"],
                            kernel_launches=launches, unit_s=unit_s,
                            setup=setup_parts)
    result["check"] = numbers
    return result


def _finite(obj):
    """The result with every non-finite number (a gap that could not be
    measured) as the largest float, so that the line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return sys.float_info.max
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        res = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  control=bool(args.control))
    except NoChip as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except ForeignModules as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    for name, n in res["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(res), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
