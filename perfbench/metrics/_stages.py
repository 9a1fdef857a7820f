"""Arithmetic the stage readers share: the program's own stage spans
(``densityflows_tpu_torch/utils/spans.py``: ``df.log_prob``, ``df.theta``,
``df.plan``, ...) inside the harness's calls of a kind.

The program stamps its spans with ``time.time_ns()``, the clock that
``torch.profiler`` stamps the slice's spans and device intervals with, so a
root span (one with no parent) belongs to the harness call whose span holds
its midpoint (one caller: the calls do not overlap), and the spans of its
``call`` with it. A stage's self time is its duration less its child spans'.
Every function returns None where the slice holds no program span of what it
reads: a program without the recorder gives no line entry.
"""

from __future__ import annotations

import bisect


def program_spans(sl) -> list:
    """The program's spans that lie within the slice; none where the
    program has no recorder."""
    try:
        from densityflows_tpu_torch.utils.spans import recorded
    except ImportError:
        return []
    return recorded(sl.t0, sl.t1)


def calls(sl, kind) -> list:
    """``[(harness span, [program spans of the call])]`` for every ``kind``
    call of the slice that holds a program root."""
    harness = sl.of(kind)
    starts = [h.start for h in harness]
    by_call: dict[int, list] = {}
    for s in program_spans(sl):
        by_call.setdefault(s.call, []).append(s)
    inside = [[] for _ in harness]
    for group in by_call.values():
        roots = [s for s in group if s.parent is None]
        if not roots:
            continue
        mid = (roots[0].start_ns + roots[0].end_ns) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= harness[i].end:
            inside[i].extend(group)
    return [(h, group) for h, group in zip(harness, inside) if group]


def self_ns(spans) -> dict:
    """index → the span's duration less its children's."""
    children: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + (s.end_ns
                                                              - s.start_ns)
    return {s.index: s.end_ns - s.start_ns - children.get(s.index, 0)
            for s in spans}


def stage_ms(sl, kind, names):
    """Mean over ``kind`` calls of the summed self time of the stages
    ``names``, in ms."""
    found, total, n_calls = False, 0, 0
    for _, group in calls(sl, kind):
        own = self_ns(group)
        for s in group:
            if s.name in names:
                found = True
                total += own[s.index]
        n_calls += 1
    return 1e-6 * total / n_calls if found else None


def own_device_ms(sl, kind, name):
    """Mean over ``kind`` calls of the summed time of the stages ``name``
    less the time in each in which device operations begun before it
    opened still run: the stage's own host and device time, without the
    wait for earlier work that a full launch queue makes its host wait
    through, in ms."""
    found, total, n_calls = False, 0, 0
    starts = [o[1] for o in sl.ops]
    for _, group in calls(sl, kind):
        own = self_ns(group)
        for s in group:
            if s.name == name:
                found = True
                before = sl.ops[:bisect.bisect_left(starts, s.start_ns)]
                end = max((e for _, _, e in before), default=s.start_ns)
                total += own[s.index] - max(
                    0, min(end, s.end_ns) - s.start_ns)
        n_calls += 1
    return 1e-6 * total / n_calls if found else None


def count_mean(sl, kind, name, key):
    """Mean over ``kind`` calls of the summed count ``key`` of the stages
    ``name``."""
    found, total, n_calls = False, 0, 0
    for _, group in calls(sl, kind):
        for s in group:
            if s.name == name and key in s.counts:
                found = True
                total += s.counts[key]
        n_calls += 1
    return total / n_calls if found else None


def count_share(sl, kinds, name, key):
    """The count ``key`` summed over the stages ``name`` of every call of
    ``kinds`` that carry it, over their number, in %."""
    hits = [s.counts[key] for kind in kinds for _, group in calls(sl, kind)
            for s in group if s.name == name and key in s.counts]
    return 100.0 * sum(hits) / len(hits) if hits else None


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def unnamed_ms(sl, kind):
    """Mean over ``kind`` calls of the time inside the harness call in
    which the device runs nothing and no stage span (a program span with a
    parent) is open, in ms."""
    total, n_calls = 0, 0
    for h, group in calls(sl, kind):
        idle = h.end - h.start - sl.busy_ns(h.start, h.end)
        stages = _merge([(max(s.start_ns, h.start), min(s.end_ns, h.end))
                         for s in group if s.parent is not None])
        named = sum(hi - lo - sl.busy_ns(lo, hi) for lo, hi in stages
                    if hi > lo)
        total += idle - named
        n_calls += 1
    return 1e-6 * total / n_calls if n_calls else None
