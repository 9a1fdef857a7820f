"""Monotonic rational-quadratic spline transforms (Neural Spline Flows).

PyTorch counterpart of ``densityflows_tpu/ops/spline.py``: an elementwise
monotone RQ spline on [-B, B] with identity tails (Durkan et al. 2019), over
(batch..., dims, K).

Parameterization per transformed dim (3K − 1 raw numbers): softmax bin
widths/heights rescaled to the interval, softplus interior knot derivatives
(boundary derivatives pinned to 1 so the spline meets the identity tails
with a continuous derivative).

The bin of each element is the count of left knot edges ≤ t, less one,
clipped to [0, K − 1], as in the JAX package (so a NaN input or NaN knots
land in bin 0, where ``torch.searchsorted`` would put a NaN past the end),
and the bin's values are picked with ``torch.gather``. The JAX package picks
them with a one-hot contraction (a TPU workaround); compiled by XLA, as every
entry point of that package runs it, the contraction is a select, and the
NaN pattern of output and ldj is the same as the gather's: an element is NaN
where a value of ITS bin is (a NaN elsewhere in its K-vector stays out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rq_spline", "n_spline_params"]

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3


def n_spline_params(n_bins: int) -> int:
    """Raw conditioner outputs per transformed dim: K widths + K heights
    + (K−1) interior derivatives."""
    return 3 * n_bins - 1


def _make_knots(raw_w, raw_h, raw_d, bound, n_bins):
    """(…, 3K−1) raw params → knot positions, heights, derivatives."""
    w = _MIN_BIN + (1 - _MIN_BIN * n_bins) * torch.softmax(raw_w, -1)
    h = _MIN_BIN + (1 - _MIN_BIN * n_bins) * torch.softmax(raw_h, -1)
    widths = 2 * bound * w
    heights = 2 * bound * h
    edge = torch.full_like(widths[..., :1], -bound)
    xk = torch.cat([edge, torch.cumsum(widths, -1) - bound], -1)
    yk = torch.cat([edge, torch.cumsum(heights, -1) - bound], -1)
    d = _MIN_DERIV + F.softplus(raw_d)
    ones = torch.ones_like(d[..., :1])
    d = torch.cat([ones, d, ones], -1)  # (…, K+1), ends pinned
    return xk, yk, widths, heights, d


def rq_spline(inputs, params, *, bound: float = 3.0, inverse: bool = False,
              with_ldj: bool = True):
    """Apply the elementwise RQ spline (or its inverse) with identity tails.

    ``inputs``: (…,) values; ``params``: (…, 3K−1) raw conditioner outputs
    broadcastable against inputs. Returns ``(outputs, ldj_elem)`` where
    ``ldj_elem`` is the per-ELEMENT log|dy/dx| — sum it over the feature axis
    for the coupling-layer ldj. ``with_ldj=False`` is the sampling path: the
    derivative and its log are never computed and ``ldj_elem`` is ``None``.
    """
    n_bins = (params.shape[-1] + 1) // 3
    raw_w = params[..., :n_bins]
    raw_h = params[..., n_bins:2 * n_bins]
    raw_d = params[..., 2 * n_bins:]
    xk, yk, widths, heights, d = _make_knots(raw_w, raw_h, raw_d, bound,
                                             n_bins)
    inside = (inputs >= -bound) & (inputs <= bound)
    # clamp for a safe pick; outside values pass through the identity
    t = torch.clamp(inputs, -bound, bound)

    knots = yk if inverse else xk
    k = ((knots[..., :-1] <= t[..., None]).sum(-1) - 1).clamp(0, n_bins - 1)
    idx = k[..., None]

    def take(a):
        return torch.gather(a.expand(idx.shape[:-1] + a.shape[-1:]), -1,
                            idx).squeeze(-1)

    x0, y0 = take(xk), take(yk)
    wk, hk = take(widths), take(heights)
    d0, d1 = take(d[..., :-1]), take(d[..., 1:])
    sk = hk / wk

    if not inverse:
        xi = (t - x0) / wk
        om = xi * (1 - xi)
        denom = sk + (d1 + d0 - 2 * sk) * om
        y = y0 + hk * (sk * xi * xi + d0 * om) / denom
        out = torch.where(inside, y, inputs)
    else:
        # solve the quadratic a ξ² + b ξ + c = 0 for ξ (Durkan et al. App. A)
        dy = t - y0
        a = hk * (sk - d0) + dy * (d1 + d0 - 2 * sk)
        b = hk * d0 - dy * (d1 + d0 - 2 * sk)
        c = -sk * dy
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        xi = 2 * c / (-b - torch.sqrt(disc))
        xi = torch.clamp(xi, 0.0, 1.0)
        om = xi * (1 - xi)
        denom = sk + (d1 + d0 - 2 * sk) * om
        x = x0 + wk * xi
        out = torch.where(inside, x, inputs)

    if not with_ldj:
        return out, None
    deriv = (sk * sk * (d1 * xi * xi + 2 * sk * om + d0 * (1 - xi) ** 2)
             ) / (denom * denom)
    ldj = torch.where(inside, torch.log(deriv), torch.zeros_like(deriv))
    if inverse:
        ldj = -ldj
    return out, ldj
