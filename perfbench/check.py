"""The comparison that decides ``correct``: the numbers that compare what the
timed path produced with the plain reference, each against its limit.

- ``logprob_gap``: the widest gap between a served log-density and the
  reference's, over every checked row, as ``|a − r| / (1 + |r|)``.
- ``sample_gap``: the same for every coordinate of every checked draw.
- ``loss_gap``, ``epoch_loss_gap``, ``fit_loss_gap``: the widest such gap
  between the NLLs a checked training call reports per epoch (of its
  training rows and of the validation rows) and the reference's replay of
  the same call (see ``generators/train.py`` for which call and epochs
  each reads).
- ``grad_gap``: the first step's gradient, as the optimizer holds it in its
  first moment, by the worst leaf: ``|‖g‖ − ‖g_ref‖| / max(‖g_ref‖, median
  leaf ‖g_ref‖)``.
- ``step_gap``: the same for each leaf's change over the checked steps.

A NaN or infinity on one side only reads as infinitely wide. Leaves whose
reference gradient is under a thousandth of the median leaf's move under Adam
by round-off alone; they are left out of both leaf numbers by that rule (no
leaf is left out by name).
"""

from __future__ import annotations

import math

import torch

__all__ = ["row_gap", "scalar_gap", "leaf_gap", "moved_leaves", "judge"]

NEGLIGIBLE = 1e-3


def row_gap(a: torch.Tensor, r: torch.Tensor) -> float:
    """``max |a − r| / (1 + |r|)`` over every element; inf where only one
    side is finite, or where the shapes differ."""
    if a.shape != r.shape:
        return math.inf
    a, r = a.detach().double(), r.detach().double()
    fa, fr = torch.isfinite(a), torch.isfinite(r)
    if bool((fa != fr).any()):
        return math.inf
    both = fa & fr
    if not bool(both.any()):
        return 0.0
    return float(((a - r).abs() / (1.0 + r.abs()))[both].max())


def scalar_gap(a: float, r: float) -> float:
    if math.isfinite(a) != math.isfinite(r):
        return math.inf
    if not math.isfinite(r):
        return 0.0
    return abs(a - r) / (1.0 + abs(r))


def moved_leaves(grad_ref: dict) -> list[str]:
    """The leaves the reference's first gradient moves: at least a
    thousandth of the median leaf's norm."""
    norms = {k: float(v.double().norm()) for k, v in grad_ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= NEGLIGIBLE * med]


def leaf_gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's ``|‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)``."""
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    worst = 0.0
    for k in names:
        pn = float(prog[k].double().norm())
        if not math.isfinite(pn):
            return math.inf
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit. A number without a limit, or a limit without a number, is not
    correct."""
    out, ok = {}, set(values) == set(limits)
    for k in sorted(set(values) | set(limits)):
        v, lim = values.get(k), limits.get(k)
        out[k] = {"value": v, "limit": lim}
        if v is None or lim is None or not (v <= lim):
            ok = False
    return ok, out
