"""Spans the benchmark puts around the program's layers from outside.

The program has no spans of its own yet, so the benchmark wraps the
entry of each layer where a run can reach it: a method of a class, or a
function of a module (every module that binds it).  Two kinds:

- :class:`Timers`: host timers that synchronize the device on entry and
  exit, each label's time excluding the timed calls it makes (the
  pattern of ``hqp_tpu_torch.prof_did1000.LayerTimers``, copied);
- :class:`Annotations`: ``torch.profiler.record_function`` ranges, which
  cost no synchronization and name what the host was doing in a trace.

Both install with ``with``, and put back exactly what they replaced.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch


class _Patches(contextlib.AbstractContextManager):
    """Replace ``owner.name`` by ``make(fn, label)`` for each target
    (owner, name, label) until exit."""

    def __init__(self, targets):
        self.targets = targets
        self._saved = []

    def make(self, fn, label):
        raise NotImplementedError

    def __enter__(self):
        for owner, name, label in self.targets:
            own = name in vars(owner)
            fn = getattr(owner, name)
            self._saved.append((owner, name, own, vars(owner).get(name)))
            setattr(owner, name, self.make(fn, label))
        return self

    def __exit__(self, *exc):
        for owner, name, own, orig in reversed(self._saved):
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._saved.clear()
        return False


class Timers(_Patches):
    """Synchronizing timers: ``excl[label]`` seconds (excluding timed
    callees) and ``calls[label]``."""

    def __init__(self, targets, sync):
        super().__init__(targets)
        self.sync = sync
        self.excl = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._stack = []

    def make(self, fn, label):
        @functools.wraps(fn)
        def timed(*a, **kw):
            self.sync()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.sync()
                dt = time.perf_counter() - t0
                child = self._stack.pop()
                self.excl[label] += dt - child
                self.calls[label] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed


class Annotations(_Patches):
    """record_function ranges named by the labels."""

    def make(self, fn, label):
        @functools.wraps(fn)
        def annotated(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return annotated
