"""Logging, counters and phase timers.

Port of ``hqp_tpu/utils/log.py``: the role of the reference's If_Log hook
and per-module logging flags (iftcl/If.h:33-49: levels
None/Error/Warning/Info/All; the ``sqp_logging`` knob) plus wall-clock
phase timers.  A phase measures host wall time only: it waits for no
device work (no ``torch.cuda.synchronize``), so wrapping a solve in a
phase adds no host sync.
"""

from __future__ import annotations

import collections
import time

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

    def phase(self, name):
        return _Phase(self, name)

    def reset(self):
        self.total.clear()
        self.count.clear()

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


#: global timers instance (the driver's per-phase accounting)
timers = Timers()
