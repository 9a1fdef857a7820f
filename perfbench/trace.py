"""The traced slice of a run: ``torch.profiler`` over a bounded part of the
window, reduced in memory to the harness's spans and the device's work.

Every call the window makes is wrapped in a ``record_function`` span named
``pb.<kind>`` (``pb.log_prob``, ``pb.sample``, ``pb.train``) and the whole
slice in ``pb.slice``. A device operation belongs to a call when it runs
inside that call's span: each call ends in a synchronisation inside its span
and one caller sends them one at a time, so this attribution needs no kernel
names and survives a renamed or split kernel. No trace file is written.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

__all__ = ["Span", "TraceSlice", "Tracer", "NullTracer"]

_PREFIX = "pb."


@dataclasses.dataclass
class Span:
    kind: str
    start: int          # ns
    end: int            # ns
    work: dict          # rows, ops, bytes, ... as the generator counted them

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-9


class TraceSlice:
    """Spans and device intervals of one traced slice (ns, one clock)."""

    def __init__(self, t0: int, t1: int, spans, device_ops):
        self.t0, self.t1 = t0, t1
        self.spans = sorted(spans, key=lambda s: s.start)
        self.ops = sorted(device_ops, key=lambda o: o[1])  # (name, start, end)
        self._merged = _merge([(s, e) for _, s, e in self.ops])
        self._starts = [s for s, _ in self._merged]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def of(self, kind: str) -> list[Span]:
        return [s for s in self.spans if s.kind == kind]

    def busy_ns(self, lo: int | None = None, hi: int | None = None) -> int:
        """Time in ``[lo, hi]`` (default: the slice) in which some device
        operation runs."""
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        total = 0
        i = max(0, bisect.bisect_right(self._starts, lo) - 1)
        while i < len(self._merged) and self._merged[i][0] < hi:
            s, e = self._merged[i]
            total += max(0, min(e, hi) - max(s, lo))
            i += 1
        return total

    def device_s(self, span: Span) -> float:
        return self.busy_ns(span.start, span.end) * 1e-9

    def busy_s(self) -> float:
        return self.busy_ns() * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device grouped by the harness span open on the host."""
        by_name: dict[str, int] = {}
        for name, s, e in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                by_name[name[:160]] = by_name.get(name[:160], 0) + (e - s)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for s, e in self._merged:
            if s > prev:
                gaps.append((prev, min(s, self.t1)))
            prev = max(prev, e)
            if prev >= self.t1:
                break
        if prev < self.t1:
            gaps.append((prev, self.t1))
        grouped: dict[str, list] = {}

        def add(name, length):
            g = grouped.setdefault(name, [0, 0, 0])
            g[0] += length
            g[1] = max(g[1], length)
            g[2] += 1

        starts = [sp.start for sp in self.spans]
        for gs, ge in gaps:
            # the gap's time inside each call span, and the rest
            j = max(0, bisect.bisect_right(starts, gs) - 1)
            inside = 0
            while j < len(self.spans) and self.spans[j].start < ge:
                sp = self.spans[j]
                part = min(ge, sp.end) - max(gs, sp.start)
                if part > 0:
                    add(f"in {sp.kind}", part)
                    inside += part
                j += 1
            if ge - gs - inside > 0:
                add("between calls (harness)", ge - gs - inside)
        idle = sorted(grouped.items(), key=lambda kv: -kv[1][0])[:top]
        return {
            "device_ops": [[n, t * 1e-9] for n, t in device_ops],
            "idle_gaps": [[f"{n}: {c} gaps, longest {m * 1e-6:.4f} ms",
                           t * 1e-9]
                          for n, (t, m, c) in idle],
        }


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class NullTracer:
    """The untraced run: spans cost nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def span(self, kind: str, **work):
        yield


class Tracer:
    """``torch.profiler`` over the slice. Use as a context manager around
    the traced loop; :meth:`span` wraps each call; :meth:`reduce` gives the
    :class:`TraceSlice` after the context has closed."""

    def __init__(self):
        self._work: dict[str, list] = {}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._record = record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._slice = record_function(_PREFIX + "slice")
        self._slice.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._slice.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def span(self, kind: str, **work):
        self._work.setdefault(kind, []).append(work)
        with self._record(_PREFIX + kind):
            yield

    def reduce(self) -> TraceSlice:
        events = self._prof.profiler.kineto_results.events()
        annotations: dict[str, list] = {}
        device_ops = []
        for ev in events:
            name = ev.name()
            on_device = str(ev.device_type()).endswith("CUDA")
            if name.startswith(_PREFIX):
                if not on_device:
                    start = ev.start_ns()
                    annotations.setdefault(name[len(_PREFIX):], []).append(
                        (start, start + ev.duration_ns()))
                continue
            if on_device and not ev.is_user_annotation():
                start = ev.start_ns()
                device_ops.append((name, start, start + ev.duration_ns()))
        if "slice" not in annotations:
            raise RuntimeError("the profiler recorded no slice span")
        t0, t1 = annotations.pop("slice")[0]
        spans = []
        for kind, works in self._work.items():
            found = sorted(annotations.get(kind, []))
            if len(found) != len(works):
                raise RuntimeError(
                    f"the profiler recorded {len(found)} spans of {kind!r} "
                    f"for {len(works)} calls")
            spans += [Span(kind, s, e, w) for (s, e), w in zip(found, works)]
        if not device_ops:
            raise RuntimeError("the profiler recorded no device operation")
        return TraceSlice(t0, t1, spans, device_ops)
