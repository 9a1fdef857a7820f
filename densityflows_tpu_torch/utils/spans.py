"""Stage spans inside the port's entry points, on the profiler's clock.

``span(name, **counts)`` marks one stage of a call (``df.theta``,
``df.plan``, ``df.enqueue``, ... inside ``df.log_prob``, ``df.train``, ...).
It records only while a ``torch.profiler`` session records (the
benchmark's traced slice, or ``utils.profiling.trace``); otherwise it
returns a shared no-op context after one check of
``torch.autograd._profiler_enabled()``: no clock read, no
``record_function``.

While a session records, a span stamps its start and end in Unix-epoch ns,
the clock that ``torch.profiler`` stamps its events with, so that a span
lines up with the device intervals of the same trace: a root reads
``time.time_ns()`` when it opens, and every stamp of its call is carried
from there by the monotonic clock, so that a step of the wall clock inside
a call (some virtual machines step it by ~0.5 ms every ~0.1 s) cannot
change a stage's duration. A span also opens ``record_function(name)``, so
that a Chrome trace shows the stage. A closed span is kept in a bounded
buffer (the last 2^20) as a :class:`Span`; :func:`recorded` reads them.

``parent`` is the index of the enclosing span of the same thread; a span
opened with none open is a root, and ``call`` is a number drawn when a root
opens and shared by every span inside it. ``counts`` holds integers: those
passed to :func:`span`, and those a stage learns while it runs. A site
computes a count only where the span records::

    with span("df.upload") as s:
        if s.recording:
            s.counts["bytes"] = a.nbytes

so that nothing but the one check runs while no session records.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "span", "unrecorded", "recorded"]

_BUFFER: collections.deque = collections.deque(maxlen=1 << 20)
_LOCAL = threading.local()
_INDEX = itertools.count()
_CALL = itertools.count()
_recording = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One closed span: times in Unix-epoch ns; ``parent`` the ``index`` of
    the enclosing span, or None for a root."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    call: int
    counts: dict


class _Off:
    """The shared context of a span while nothing records."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "index", "parent", "call", "start",
                 "origin", "_fn", "_stack")
    recording = True

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        outer = stack[-1] if stack else None
        self.index = next(_INDEX)
        self._stack = stack
        stack.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        if outer is None:
            self.parent, self.call = None, next(_CALL)
            self.origin = time.time_ns() - time.perf_counter_ns()
        else:
            self.parent, self.call = outer.index, outer.call
            self.origin = outer.origin
        self.start = self.origin + time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = self.origin + time.perf_counter_ns()
        self._fn.__exit__(*exc)
        self._stack.pop()
        _BUFFER.append(Span(self.index, self.name, self.start, end,
                            self.parent, self.call, self.counts))
        return False


def span(name: str, **counts):
    """A context manager around one stage of a call; ``counts``: integers
    kept with the span (module docstring)."""
    if not _recording():
        return _OFF
    return _On(name, counts)


def unrecorded(name: str, **counts):
    """The context of :func:`span` while nothing records, whether or not a
    session does: for a site that per-batch or per-chunk loops reach as
    well as entry points."""
    return _OFF


def recorded(t0_ns: int | None = None, t1_ns: int | None = None) -> list:
    """The recorded spans that lie within ``[t0_ns, t1_ns]`` (Unix-epoch
    ns; None: unbounded), in the order they closed."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [s for s in list(_BUFFER) if s.start_ns >= lo and s.end_ns <= hi]
