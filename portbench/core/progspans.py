"""The program's own spans in a torch.profiler trace: device time by the
span that launched it.

While the port records its spans (``hqp_tpu_torch.utils.log``), each
span is also a ``record_function`` range of its name in an active
profiler's trace.  :func:`launch_events` reads such a trace: the ranges
whose names are the program's spans, and every device operation with the
host time of its launch: the start of the host-side CUDA API call (a
name that starts with ``cu``) that shares the operation's kineto
``correlation_id``.  (``linked_correlation_id`` would name the
torch operator that launched it, but a kernel launched from outside
torch's operators, as the port's K1 and K2 are through ctypes, is linked
to none.)
:func:`device_by_span` charges each operation's device time to every
span open on the host at its launch, so a span's time includes its
children's.  The operation may run long after its span closed: the
launch decides.
"""

from __future__ import annotations

import collections

import torch


def launch_events(prof, names):
    """(spans, ops) of a finished ``torch.profiler.profile``: spans
    [(name, start_ns, end_ns)] of the host ranges named in ``names``, and
    ops [(name, start_ns, end_ns, launch_ns)] of the device operations
    (the device side of an annotation is none), ``launch_ns`` None where
    no launch could be found."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.is_user_annotation():
            if e.name() in names:
                spans.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    return spans, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     launch.get(e.correlation_id())) for e in dev]


def device_by_span(spans, ops):
    """Device seconds by span name, each span's including its children's:
    every op is charged once to each name open at its launch.  Ops
    launched while no span was open go under ``host``, ops without a
    launch time under ``unlinked``."""
    marks = sorted([(a, 1, n) for n, a, _ in spans]
                   + [(b, 0, n) for n, _, b in spans])
    out = collections.defaultdict(float)
    opened = collections.Counter()
    i = 0
    for t, secs in sorted((t, (b - a) * 1e-9) for _, a, b, t in ops
                          if t is not None):
        while i < len(marks) and marks[i][0] <= t:
            _, is_start, n = marks[i]
            opened[n] += 1 if is_start else -1
            i += 1
        live = [n for n, c in opened.items() if c > 0]
        for n in live or ("host",):
            out[n] += secs
    unlinked = sum((b - a) * 1e-9 for _, a, b, t in ops if t is None)
    if unlinked:
        out["unlinked"] += unlinked
    return dict(out)
