"""Reading a torch.profiler trace: device busy time, the device
operations that took most time, and the idle gaps by the host span that
was open.

The busy/idle arithmetic is the union of device intervals of
``hqp_tpu_torch.prof_did1000.device_trace`` (copied), taken over the
window that the ``window`` annotation spans.  Each stretch of idle time is
attributed to the innermost annotation
(:class:`portbench.core.hooks.Annotations`) open on the host during it,
or to ``host`` where none was.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

WINDOW = "window"


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    events: int                 # device events (kernels, copies, sets)
    by_name: dict               # device op name -> [seconds, count]
    idle_by_label: dict         # host span label -> idle seconds

    def device_seconds(self, patterns):
        """Device seconds and launches of the ops whose names contain one
        of ``patterns``."""
        secs = n = 0
        for name, (s, c) in self.by_name.items():
            if any(p in name for p in patterns):
                secs += s
                n += c
        return secs, n

    def top_ops(self, k=10):
        return [[name, s] for name, (s, _) in sorted(
            self.by_name.items(), key=lambda kv: -kv[1][0])[:k]]

    def top_idle(self, k=10):
        return [[lab, s] for lab, s in sorted(
            self.idle_by_label.items(), key=lambda kv: -kv[1])[:k]]


def _union(spans):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _timeline(ann, lo, hi):
    """[(start, end, label)] segments of [lo, hi] labelled by the
    innermost open annotation (annotations nest: one host thread)."""
    marks = []
    for a, b, lab in ann:
        marks.append((a, 1, lab))
        marks.append((b, 0, lab))
    marks.sort(key=lambda m: (m[0], m[1]))
    segs, stack, t = [], [], lo
    for pos, is_start, lab in marks:
        pos = min(max(pos, lo), hi)
        if pos > t:
            segs.append((t, pos, stack[-1] if stack else "host"))
            t = pos
        if is_start:
            stack.append(lab)
        elif lab in stack:
            # pop the innermost occurrence of this label
            i = len(stack) - 1 - stack[::-1].index(lab)
            stack.pop(i)
    if hi > t:
        segs.append((t, hi, stack[-1] if stack else "host"))
    return segs


def reduce(events, labels):
    """A :class:`Trace` from raw profiler events given as tuples
    (is_device, name, start_ns, end_ns); ``labels`` are the annotation
    names that attribute idle time.  The window is what the
    :data:`WINDOW` annotation spans or, in a trace without one, the
    first device operation's start to the last one's end.  None where no
    device event was recorded."""
    ann, dev = [], []
    for is_dev, name, a, b in events:
        if is_dev:
            dev.append((a, b, name))
        elif name in labels:
            ann.append((a, b, name))
    if not dev:
        return None
    wins = [(a, b) for a, b, lab in ann if lab == WINDOW] or \
        [(min(a for a, _, _ in dev), max(b for _, b, _ in dev))]
    lo, hi = min(a for a, _ in wins), max(b for _, b in wins)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    n = 0
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        n += 1
        by_name[name][0] += (b - a) * 1e-9
        by_name[name][1] += 1
        spans.append((a, b))
    busy = _union(spans)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    segs = _timeline([x for x in ann if x[2] != WINDOW], lo, hi)
    idle = collections.defaultdict(float)
    i = 0
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, lab = segs[j]
            idle[lab] += (min(b, s1) - max(a, s0)) * 1e-9
            j += 1
    return Trace(busy_s=sum(b - a for a, b in busy) * 1e-9,
                 window_s=(hi - lo) * 1e-9, events=n,
                 by_name={k: list(v) for k, v in by_name.items()},
                 idle_by_label=dict(idle))


def profiler_events(prof, labels):
    """The raw events of a finished ``torch.profiler.profile`` that
    :func:`reduce` reads: device operations (the GPU side of an
    annotation is none) and the host annotations named by ``labels``."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        ann = e.is_user_annotation()
        if e.device_type() == cuda:
            if not ann:
                out.append((True, e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        elif ann and e.name() in labels:
            out.append((False, e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out
