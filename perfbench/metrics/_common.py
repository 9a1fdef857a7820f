"""Arithmetic the per-layer readers share: shares of the peak and of the
roofline over a kind of call, and the host's part of a call."""

from __future__ import annotations

from ..work import PEAK_FLOPS, least_seconds


def mfu(sl, kind):
    """Operations of every ``kind`` call over their summed wall time at
    the peak, in %; None where the slice holds no such call."""
    spans = sl.of(kind)
    wall = sum(s.wall_s for s in spans)
    if not spans or wall <= 0:
        return None
    return 100.0 * sum(s.work["ops"] for s in spans) / (wall * PEAK_FLOPS)


def roofline(sl, kind):
    """The least time of every ``kind`` call (the larger of operations over
    the peak rate and bytes over the peak bandwidth) over the device time of
    everything that ran inside those calls, in %."""
    spans = sl.of(kind)
    device = sum(sl.device_s(s) for s in spans)
    if not spans or device <= 0:
        return None
    least = sum(least_seconds(s.work["ops"], s.work["bytes"]) for s in spans)
    return 100.0 * least / device


def host_ms(sl, kind):
    """Mean over ``kind`` calls of the wall time in which the device ran
    nothing of the call, in ms."""
    spans = sl.of(kind)
    if not spans:
        return None
    return 1e3 * sum(s.wall_s - sl.device_s(s) for s in spans) / len(spans)


def idle(sl, kinds):
    """The share of the slice in which no device operation runs, in %;
    None where the slice holds none of ``kinds``."""
    if not any(sl.of(k) for k in kinds) or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
