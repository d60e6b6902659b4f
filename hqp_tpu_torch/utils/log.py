"""Logging, counters, phase timers and the port's span recorder.

Port of ``hqp_tpu/utils/log.py``: the role of the reference's If_Log hook
and per-module logging flags (iftcl/If.h:33-49: levels
None/Error/Warning/Info/All; the ``sqp_logging`` knob) plus wall-clock
phase timers.  A phase measures host wall time only: it waits for no
device work (no ``torch.cuda.synchronize``), so wrapping a solve in a
phase adds no host sync.

Spans (:meth:`Timers.span`, :func:`spanned`) mark the port's layers where
the work happens: the scenario batch, the QP build and presolve,
Mehrotra's solve, cold start and the phases of its step, the partitioned
KKT backend's factor and solves, and the refinement of a KKT solve.  The
global :data:`timers` records them, and only while :data:`TRACING` is set
(:func:`set_tracing`; off by default).  Off, a span is one test of that
flag and a shared no-op context.  On, each span records its name, its
start and end on ``time.perf_counter_ns``, its parent, its unit (the root
span it descends from, so that every span of one solve shares it), and
the counted host reads (:mod:`hqp_tpu_torch.utils.sync`) made while it was
the innermost open span, with the nanoseconds the host waited in them.
Recording synchronizes nothing and launches nothing on the device.  While
a torch profiler is active, each span also opens a ``record_function``
range of its name, so the spans appear in the profiler's trace beside the
device operations they launched; :meth:`Timers.epoch_ns` puts a record's
times on the profiler's clock (Unix-epoch nanoseconds).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import time

import torch

LOG_NONE = 0
LOG_ERROR = 1
LOG_WARNING = 2
LOG_INFO = 3
LOG_ALL = 4

_LEVEL_NAMES = {0: "none", 1: "error", 2: "warning", 3: "info", 4: "all"}

#: global log level (If_Log's static level)
level = LOG_WARNING


def set_level(lv):
    global level
    if isinstance(lv, str):
        lv = {v: k for k, v in _LEVEL_NAMES.items()}[lv]
    level = int(lv)


def log(lv, category, msg):
    """If_Log(category, ...) analog; prints when lv <= current level."""
    if lv <= level:
        print(f"[{_LEVEL_NAMES.get(lv, lv)}] {category}: {msg}")


def error(category, msg):
    log(LOG_ERROR, category, msg)


def warning(category, msg):
    log(LOG_WARNING, category, msg)


def info(category, msg):
    log(LOG_INFO, category, msg)


class Timers:
    """Named wall-clock phase timers with call counts.

    Usage::

        with timers.phase("qp_solve"):
            ...
        timers.report()
    """

    def __init__(self):
        self.total = collections.defaultdict(float)
        self.count = collections.defaultdict(int)
        #: the spans recorded since the last reset, in the order they opened
        self.records = []
        #: (time.time_ns(), time.perf_counter_ns()) read together when
        #: tracing was last switched on
        self.anchor = None
        self._open = []
        self._ids = itertools.count()

    def phase(self, name):
        return _Phase(self, name)

    def span(self, name):
        """A span named ``name`` (a context manager): recorded while
        :data:`TRACING` is set, else the shared no-op context."""
        if not TRACING:
            return _NO_SPAN
        return _Span(self, name)

    def host_read(self, read):
        """``read()``, a host read, timed and charged to the innermost
        open span (:func:`hqp_tpu_torch.utils.sync.read` calls it while
        tracing)."""
        t0 = time.perf_counter_ns()
        out = read()
        if self._open:
            rec = self._open[-1]
            rec.reads += 1
            rec.read_ns += time.perf_counter_ns() - t0
        return out

    def epoch_ns(self, t_ns):
        """A ``time.perf_counter_ns`` reading as Unix-epoch nanoseconds,
        the clock of the profiler's events."""
        return self.anchor[0] + (t_ns - self.anchor[1])

    def reset(self):
        self.total.clear()
        self.count.clear()
        self.records.clear()

    def report(self):
        return {name: {"s": round(self.total[name], 6),
                       "calls": self.count[name]}
                for name in sorted(self.total)}


class _Phase:
    def __init__(self, timers, name):
        self.timers = timers
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timers.total[self.name] += time.perf_counter() - self.t0
        self.timers.count[self.name] += 1
        return False


@dataclasses.dataclass(slots=True, eq=False)
class SpanRecord:
    """One recorded span; times are ``time.perf_counter_ns`` readings."""

    id: int
    name: str
    parent: int | None       # the enclosing span's id; None for a root
    unit: int                # the root span's id (its own for a root)
    start_ns: int
    end_ns: int = -1         # -1 while the span is open
    reads: int = 0           # counted host reads made while innermost
    read_ns: int = 0         # nanoseconds the host waited in those reads
    child_ns: int = 0        # nanoseconds its direct children cover

    @property
    def self_ns(self):
        """The duration less the parts its children cover."""
        return self.end_ns - self.start_ns - self.child_ns


class _Span:
    __slots__ = ("timers", "name", "rec", "rf")

    def __init__(self, timers, name):
        self.timers = timers
        self.name = name

    def __enter__(self):
        t = self.timers
        start = time.perf_counter_ns()
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rid = next(t._ids)
        up = t._open[-1] if t._open else None
        rec = SpanRecord(rid, self.name, up.id if up else None,
                         up.unit if up else rid, start)
        t.records.append(rec)
        t._open.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        opened = self.timers._open
        opened.pop()
        if opened:
            opened[-1].child_ns += rec.end_ns - rec.start_ns
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()

#: the span recorder's switch (:func:`set_tracing`); off by default
TRACING = False

#: the port's one recorder: phase timers and, while :data:`TRACING`, spans
timers = Timers()


def set_tracing(on):
    """Switch the recording of spans by :data:`timers` on or off;
    switching on reads its clock anchor anew."""
    global TRACING
    if on:
        timers.anchor = (time.time_ns(), time.perf_counter_ns())
    TRACING = bool(on)


def spanned(name):
    """Decorator: each call of the function is a span named ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with timers.span(name):
                return fn(*args, **kwargs)
        return inner
    return deco
