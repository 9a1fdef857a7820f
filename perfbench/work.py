"""The work of each entry point, counted from a configuration's shapes alone,
whatever implements them, and the peaks it is held against.

Each kind counts its own (``kinds/<kind>.py``'s ``Work``, found by
:func:`of`), by these rules:

- Operations: 2·K·N per row for every conditioner product (K inputs, N
  outputs), counted once: the model's products, not an implementation's
  passes (a 3xTF32 product is one product here).
- A training row costs three times its forward products (forward, and the
  two products of the backward pass).
- Bytes: each input read once and each output written once.

The peak is the H100's dense TF32 rate: the highest rate at which the card
computes a product whose inputs keep at least TF32's precision, so that no
run that passes the float32 comparison can read over 100 %.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "F32", "of", "least_seconds"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = 495e12     # TF32 tensor cores
PEAK_BYTES = 3.35e12    # HBM3

F32 = 4


def of(cfg):
    """The work model of ``cfg``'s kind: ``logprob(rows)``, ``sample(rows,
    grid)`` and ``train(rows, steps)``, each ``(operations, bytes)``."""
    from . import kinds

    return kinds.module(cfg).Work(cfg)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
