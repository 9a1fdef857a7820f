"""Structured metrics logging (JSONL).

Own copy of ``densityflows_tpu/utils/logging.py``: one JSON object per line
with a monotonic step, wall time and arbitrary metric fields — greppable,
plottable, and append-safe across resumed runs.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Append-only JSONL metrics writer.

    >>> log = MetricsLogger("run1/metrics.jsonl")      # doctest: +SKIP
    >>> log.write(epoch=3, train_nll=3.2, valid_nll=3.3)  # doctest: +SKIP
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._step = 0

    def write(self, **metrics) -> None:
        rec = {"step": self._step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._step += 1

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
