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

:func:`rq_spline_nflows` is nflows' ``unconstrained_rational_quadratic_spline``
with linear tails, in nflows' arithmetic (knots pinned at ±B, bin sizes as
knot differences, boundary derivatives through the softplus of a constant,
``log`` of numerator less twice the ``log`` of the denominator): the
transform of nflows' spline couplings, and so of Dingo's flows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rq_spline", "rq_spline_nflows", "n_spline_params"]

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


def _nflows_knots(raw, lo, hi, minimum):
    """Cumulative knots on [lo, hi] (ends pinned) and the bin sizes."""
    k = raw.shape[-1]
    frac = minimum + (1.0 - minimum * k) * torch.softmax(raw, dim=-1)
    cum = torch.cumsum(frac, dim=-1)
    cum = (hi - lo) * cum[..., :-1] + lo
    edge = torch.full_like(cum[..., :1], lo)
    cum = torch.cat([edge, cum, torch.full_like(edge, hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rq_spline_nflows(inputs, params, *, bound: float = 1.0,
                     inverse: bool = False, with_ldj: bool = True):
    """nflows' RQ spline on ``[-bound, bound]``, identity outside:
    ``(outputs, per-element log|dy/dx|)`` (``None`` without ``with_ldj``).
    ``params``: (…, 3K−1) raw widths, heights and inner derivatives, in
    nflows' order, after any scaling of the widths and heights."""
    k = (params.shape[-1] + 1) // 3
    uw, uh = params[..., :k], params[..., k:2 * k]
    const = math.log(math.expm1(1.0 - _MIN_DERIV))
    ud = F.pad(params[..., 2 * k:], (1, 1), value=const)
    inside = (inputs >= -bound) & (inputs <= bound)
    xc = torch.clamp(inputs, -bound, bound)
    cw, widths = _nflows_knots(uw, -bound, bound, _MIN_BIN)
    ch, heights = _nflows_knots(uh, -bound, bound, _MIN_BIN)
    deriv = _MIN_DERIV + F.softplus(ud)
    locs = (ch if inverse else cw).detach().clone()
    locs[..., -1] += 1e-6
    idx = (torch.sum(xc[..., None] >= locs, dim=-1) - 1)[..., None]

    def at(a):
        return a.gather(-1, idx)[..., 0]

    x0, w, y0, hh = at(cw), at(widths), at(ch), at(heights)
    delta = hh / w
    d0, d1 = at(deriv[..., :-1]), at(deriv[..., 1:])
    if not inverse:
        theta = (xc - x0) / w
        tt = theta * (1 - theta)
        numer = hh * (delta * theta ** 2 + d0 * tt)
        denom = delta + (d0 + d1 - 2 * delta) * tt
        out = y0 + numer / denom
    else:
        dy = xc - y0
        a = dy * (d0 + d1 - 2 * delta) + hh * (delta - d0)
        b = hh * d0 - dy * (d0 + d1 - 2 * delta)
        c = -delta * dy
        disc = torch.clamp(b ** 2 - 4 * a * c, min=0.0)
        theta = (2 * c) / (-b - torch.sqrt(disc))
        tt = theta * (1 - theta)
        denom = delta + (d0 + d1 - 2 * delta) * tt
        out = theta * w + x0
    if not with_ldj:
        return torch.where(inside, out, inputs), None
    dnum = delta ** 2 * (d1 * theta ** 2 + 2 * delta * tt
                         + d0 * (1 - theta) ** 2)
    lad = torch.log(dnum) - 2 * torch.log(denom)
    if inverse:
        lad = -lad
    return (torch.where(inside, out, inputs),
            torch.where(inside, lad, torch.zeros_like(lad)))
