"""Profiling & observability: step timing, throughput counters, traces.

PyTorch counterpart of ``densityflows_tpu/utils/profiling.py``: wall-clock
step timers that wait for the device before they read the clock,
samples/s/chip counters normalized by the local device count, and a thin
wrapper over ``torch.profiler`` for traces viewable in Perfetto or
``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

__all__ = ["StepTimer", "Throughput", "trace", "annotate", "device_count"]


def device_count() -> int:
    """The CUDA devices this process sees (chips on this host), 1 without
    one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _wait(tree) -> None:
    """Wait for the devices of the CUDA tensors in ``tree`` (any nesting of
    tuples, lists and dicts) to finish their queued work."""
    devices = set()

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(tree)
    for device in devices:
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StepTimer:
    """Wall-clock timer that waits for device completion.

    >>> timer = StepTimer()
    >>> with timer.step(result_tensors):  # doctest: +SKIP
    ...     ...
    >>> timer.mean_ms  # doctest: +SKIP
    """

    times: list = dataclasses.field(default_factory=list)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, block_on: Any = None) -> float:
        """Stop the timer; the devices of the CUDA tensors in ``block_on``
        are waited on first, so queued kernels do not fake the number."""
        if block_on is not None:
            _wait(block_on)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self, block_on: Any = None):
        self.start()
        yield
        self.stop(block_on)

    @property
    def mean_ms(self) -> float:
        return 1e3 * float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50_ms(self) -> float:
        return 1e3 * float(np.percentile(self.times, 50)) if self.times else 0.0

    @property
    def p99_ms(self) -> float:
        return 1e3 * float(np.percentile(self.times, 99)) if self.times else 0.0


@dataclasses.dataclass
class Throughput:
    """samples/s (/chip) counter fed by (count, seconds) pairs."""

    total_items: int = 0
    total_seconds: float = 0.0

    def add(self, items: int, seconds: float) -> None:
        self.total_items += int(items)
        self.total_seconds += float(seconds)

    @property
    def per_sec(self) -> float:
        return self.total_items / self.total_seconds if self.total_seconds else 0.0

    @property
    def per_sec_per_chip(self) -> float:
        return self.per_sec / max(1, device_count())


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of CPU and, where present, CUDA
    activity, written to ``logdir`` as a Chrome trace
    (``trace_<pid>_<n>.json``; view in Perfetto or ``chrome://tracing``).

    >>> with trace('traces/run'):  # doctest: +SKIP
    ...     train(flow, data, epochs=1)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Named region that shows up on the profiler timeline."""
    return torch.profiler.record_function(name)
