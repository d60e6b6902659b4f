"""The program's own spans and counters in one cell, read on the card.

    python3 -m portbench.tools.spans --workload did60_scen.montecarlo \
        --seed 7 [--out spans.jsonl]

Set-up is a run's (``portbench.run``): the configured program, the draws
from the seed, one warm unit of work.  Then six units of work:

1. untraced;
2. under torch.profiler (host and device) with the benchmark's
   annotations (``core/hooks.Annotations``, ``window``, ``unit``) and the
   program's tracing on (``hqp_tpu_torch.utils.log.set_tracing``): the
   device time by the program span that launched it
   (``core/progspans``) and the idle time by the innermost open range,
   the program's spans among the labels;
3. under the benchmark's synchronizing spans (``core/hooks.Timers``);
4. with the program's tracing on, no profiler and no synchronizing
   timer: the host's waits in its reads, and each span's self time;
5. and 6. untraced, each on unit 4's draw: ``bit_identical`` holds if
   unit 5's answer equals unit 4's to the bit, with the same host reads
   and kernel launches; ``repeatable`` if unit 6's equals unit 5's.

One line of JSON goes to standard output (and to ``--out``): the five
readings this measures under ``metrics`` (``refine_rounds_per_solve``
over the six units; ``kkt_factor_dev_ms_per_ip``,
``kkt_solve_dev_ms_per_ip``, ``refine_dev_ms_per_ip`` from unit 2, per IP
step of that unit; ``host_wait_share`` from unit 4: the nanoseconds the
host waited in reads inside ``mehrotra.solve`` over that span's
duration), each unit's seconds and steps, the device time and idle time
by span, and unit 4's spans by name.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time


def _setup(workload, seed, device, overrides):
    """The cell's program and draws after one warm unit, as a run makes
    them (``overrides``: configuration keys replaced)."""
    from portbench import run as bench_run
    from portbench.core import spec, system, traffic

    cell = spec.load_cell(workload)
    bench_run.cache_dirs(spec.ROOT)
    cfg = dict(cell.config, **(overrides or {}))
    traffic.check_traffic(cell.traffic)
    ref = spec.reference(cfg)
    sut = system.System(cfg, device, ref=ref)
    draws = traffic.Draws(ref.base_iterate(cfg, sut.prg.device),
                          sut.batch, cell.traffic["scale"], seed,
                          sut.prg.device)
    sut.run(draws.next())
    return sut, draws


def host_wait_share(records):
    """100 x the nanoseconds the host waited in counted reads inside the
    ``mehrotra.solve`` spans over those spans' duration; None without
    one."""
    inside, wait, whole = {}, 0, 0
    for r in records:                      # parents open before children
        root = r.name == "mehrotra.solve"
        inside[r.id] = root or inside.get(r.parent, False)
        if inside[r.id]:
            wait += r.read_ns
        if root:
            whole += r.end_ns - r.start_ns
    return 100.0 * wait / whole if whole else None


def by_name(records, steps):
    """Each span name's calls and, per IP step, self ms, reads and ms
    waited in them."""
    out = collections.defaultdict(lambda: [0, 0, 0, 0])
    for r in records:
        o = out[r.name]
        o[0] += 1
        o[1] += r.self_ns
        o[2] += r.reads
        o[3] += r.read_ns
    return {n: dict(calls=c, self_ms_per_ip=s * 1e-6 / steps,
                    reads_per_ip=k / steps, wait_ms_per_ip=w * 1e-6 / steps)
            for n, (c, s, k, w) in sorted(out.items(), key=lambda kv:
                                          -kv[1][1])}


def measure(workload, seed, device="cuda", overrides=None):
    """The readings of one cell (see the module's doc) as a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hqp_tpu_torch.qp import kkt
    from hqp_tpu_torch.utils import log
    from hqp_tpu_torch.utils import sync as host_sync
    from portbench import run as bench_run
    from portbench.core import hooks, progspans
    from portbench.core import trace as trace_mod

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sut, draws = _setup(workload, seed, device, overrides)
    outputs = sut.outputs()
    sync()
    r0, c0 = kkt.REFINE_ROUNDS, kkt.REFINE_CALLS
    units, secs, syncs, launches = [], [], [], []

    def one(v=None):
        v = draws.next() if v is None else v
        n0, k0 = host_sync.COUNT, sut.kernel_launches()
        t = time.perf_counter()
        units.append(sut.run(v))
        sync()
        secs.append(time.perf_counter() - t)
        syncs.append(host_sync.COUNT - n0)
        launches.append({k: n - k0[k]
                         for k, n in sut.kernel_launches().items()})

    one()                                                   # 1
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    log.timers.reset()
    log.set_tracing(True)
    try:                                                    # 2
        with profile(activities=acts) as prof:
            with hooks.Annotations(sut.span_targets()):
                with record_function("window"):
                    with record_function("unit"):
                        one()
    finally:
        log.set_tracing(False)
    names = sorted({r.name for r in log.timers.records})
    spans, ops = progspans.launch_events(prof, names)
    dev = progspans.device_by_span(spans, ops)
    gaps = trace_mod.reduce(trace_mod.profiler_events(
        prof, bench_run.LABELS + tuple(names)),
        bench_run.LABELS + tuple(names))
    del prof
    with hooks.Timers(sut.span_targets(), sync):            # 3
        one()
    log.timers.reset()
    log.set_tracing(True)
    try:                                                    # 4
        one()
    finally:
        log.set_tracing(False)
    records = list(log.timers.records)
    log.timers.reset()
    one(units[3].v)                                         # 5
    one(units[3].v)                                         # 6
    rounds, calls = kkt.REFINE_ROUNDS - r0, kkt.REFINE_CALLS - c0

    def same(i, j):
        return all(torch.equal(x, y) for x, y in zip(
            _leaves(outputs(units[i])), _leaves(outputs(units[j])),
            strict=True)) and syncs[i] == syncs[j] and \
            launches[i] == launches[j]

    steps = [bench_run.tally([u], outputs)["ip"] for u in units]
    ip2 = steps[1]

    def per_ip(name):
        return 1e3 * dev[name] / ip2 if dev.get(name) else None

    metrics = dict(
        refine_rounds_per_solve=rounds / calls if calls else None,
        kkt_factor_dev_ms_per_ip=per_ip("partitioned.factor"),
        kkt_solve_dev_ms_per_ip=per_ip("partitioned.solve"),
        refine_dev_ms_per_ip=per_ip("kkt.refine"),
        host_wait_share=host_wait_share(records))
    return dict(
        workload=workload, seed=seed, metrics=metrics,
        bit_identical=same(3, 4), repeatable=same(4, 5), unit_s=secs,
        steps=steps, syncs=syncs,
        kernel_launches=launches, refine=dict(rounds=rounds, calls=calls),
        unit2=dict(busy_ms_per_ip=(1e3 * gaps.busy_s / ip2
                                   if gaps is not None else None),
                   window_s=gaps.window_s if gaps is not None else None,
                   device_ms_by_span={n: 1e3 * s for n, s in sorted(
                       dev.items(), key=lambda kv: -kv[1])},
                   linked_ops=sum(t is not None for *_, t in ops),
                   ops=len(ops),
                   idle_gaps=gaps.top_idle(20) if gaps is not None
                   else []),
        unit4=by_name(records, steps[3]),
        device=dict(kind=torch.cuda.get_device_name() if cuda else "cpu",
                    power_limit=bench_run.power_limit() if cuda else "",
                    torch=torch.__version__, cuda=torch.version.cuda))


def _leaves(ans):
    out = [ans["x"], ans["iters"], ans["optimal"]]
    for part in ("y", "z", "w"):
        out += [ans[part][k] for k in sorted(ans[part])]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    line = json.dumps(measure(args.workload, args.seed))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
