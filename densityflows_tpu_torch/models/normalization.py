"""Normalization, permutation and logit layers.

PyTorch counterpart of ``densityflows_tpu/models/normalization.py``.
:class:`NormalizationLayer` is a non-trainable per-dim affine rescale mapping
``[x_min, x_max] → [α, β]`` in the inverse (data→latent) direction with a
constant log-det-Jacobian, typically placed last in a chain to tame
exp-overflow; its bounds are buffers, not parameters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.coupling import take_last

__all__ = [
    "NormalizationLayer", "normalization_layer",
    "PermutationLayer", "permutation_layer",
    "LogitLayer", "logit_layer",
]


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


class NormalizationLayer(nn.Module):
    """Per-dim affine rescale. ``x_min``/``x_max``: (d,) data range
    (buffers); ``alpha``/``beta``: static scalar output bounds (β > α)."""

    def __init__(self, x_min, x_max, alpha: float = 0.0, beta: float = 1.0):
        super().__init__()
        self.register_buffer("x_min", x_min)
        self.register_buffer("x_max", x_max)
        self.alpha, self.beta = float(alpha), float(beta)

    def _bounds(self):
        return self.x_min, self.x_max, self.x_max - self.x_min, \
            self.beta - self.alpha

    def _const_ldj(self, batch_shape):
        _, _, diff, delta = self._bounds()
        return torch.log(diff / delta).sum().expand(batch_shape)

    def inverse(self, x, theta=None):
        """data → latent: map [x_min,x_max] → [α,β]; ldj = −Σ log(Δx/δ)."""
        lo, hi, diff, _ = self._bounds()
        z = (self.beta * (x - lo) + self.alpha * (hi - x)) / diff
        return z, -self._const_ldj(x.shape[:-1])

    def forward(self, z, theta=None):
        """latent → data inverse map; ldj = +Σ log(Δx/δ)."""
        return self.forward_(z), self._const_ldj(z.shape[:-1])

    def forward_(self, z, theta=None):
        lo, hi, diff, delta = self._bounds()
        return (diff * z - self.alpha * hi + self.beta * lo) / delta

    def summarize(self) -> str:
        return "Normalization Layer"


class PermutationLayer(nn.Module):
    """Fixed feature permutation (ldj = 0)."""

    def __init__(self, perm):
        super().__init__()
        self.perm = tuple(int(i) for i in perm)

    def _inv(self):
        inv = np.empty(len(self.perm), np.int64)
        inv[list(self.perm)] = np.arange(len(self.perm))
        return inv.tolist()

    def forward(self, z, theta=None):
        return self.forward_(z), z.new_zeros(z.shape[:-1])

    def inverse(self, x, theta=None):
        return take_last(x, self._inv()), x.new_zeros(x.shape[:-1])

    def forward_(self, z, theta=None):
        return take_last(z, self.perm)

    def summarize(self) -> str:
        return f"Permutation Layer {list(self.perm)}"


def permutation_layer(perm_or_d, *, generator=None) -> PermutationLayer:
    """``permutation_layer([2,0,1])`` for an explicit permutation, or
    ``permutation_layer(d, generator=...)`` for a random one (reversed range
    when no generator is given)."""
    if isinstance(perm_or_d, int):
        d = perm_or_d
        if generator is None:
            perm = tuple(reversed(range(d)))
        else:
            perm = tuple(int(i) for i in torch.randperm(
                d, generator=generator, device=generator.device).tolist())
    else:
        perm = tuple(int(i) for i in perm_or_d)
        if sorted(perm) != list(range(len(perm))):
            raise ValueError(f"{perm} is not a permutation of range({len(perm)})")
    return PermutationLayer(perm)


class LogitLayer(nn.Module):
    """Smooth bijection between the box (lo, hi)^d and all of ℝ^d.

    ``forward`` (latent → data): x = lo + (hi − lo)·σ(z);
    ``inverse`` (data → latent): z = logit((x − lo)/(hi − lo)), with the
    argument clamped to [eps, 1−eps] for edge samples. ldj computed via
    log-sigmoid for stability.
    """

    def __init__(self, lo, hi, eps: float = 1e-6):
        super().__init__()
        self.register_buffer("lo", lo)
        self.register_buffer("hi", hi)
        self.eps = float(eps)

    def _logdet_fwd(self, z):
        width = torch.log(self.hi - self.lo)
        return (-F.softplus(-z) - F.softplus(z) + width).sum(-1)

    def forward(self, z, theta=None):
        return self.forward_(z), self._logdet_fwd(z)

    def inverse(self, x, theta=None):
        u = ((x - self.lo) / (self.hi - self.lo)).clamp(self.eps,
                                                        1.0 - self.eps)
        z = torch.log(u) - torch.log1p(-u)
        return z, -self._logdet_fwd(z)

    def forward_(self, z, theta=None):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(z)

    def summarize(self) -> str:
        return f"Logit Layer       | d = {self.lo.shape[0]}"


def logit_layer(x, *, margin: float = 0.0, eps: float = 1e-6,
                device=None) -> LogitLayer:
    """Build from data bounds (min/max over all batch dims, widened by
    ``margin``·range on each side). Accepts an array ``(batch..., d)``, a
    :class:`~densityflows_tpu_torch.data.DataArrays`, or an ``(lo, hi)``
    tuple of per-dim bounds."""
    from ..data import DataArrays

    device = resolve_device(device)
    if isinstance(x, tuple) and len(x) == 2:
        lo = np.asarray(x[0], np.float32)
        hi = np.asarray(x[1], np.float32)
    else:
        if isinstance(x, DataArrays):
            x = x.x
        x = np.asarray(x, np.float32)
        flat = x.reshape(-1, x.shape[-1])
        lo, hi = flat.min(axis=0), flat.max(axis=0)
        pad = margin * (hi - lo)
        lo, hi = lo - pad, hi + pad
    if np.any(hi <= lo):
        raise ValueError("logit_layer needs hi > lo in every dim")
    return LogitLayer(_f32(lo, device), _f32(hi, device), float(eps))


def normalization_layer(x, alpha: float = 0.0, beta: float = 1.0, *,
                        device=None) -> NormalizationLayer:
    """Build from data min/max over all batch dims (also accepts a
    :class:`~densityflows_tpu_torch.data.DataArrays`)."""
    from ..data import DataArrays

    device = resolve_device(device)
    if isinstance(x, DataArrays):
        x = x.x
    if beta <= alpha:
        raise ValueError("normalization bounds must satisfy beta > alpha")
    x = np.asarray(x)
    flat = x.reshape(-1, x.shape[-1])
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    degenerate = np.flatnonzero(hi <= lo)
    if degenerate.size:
        raise ValueError(
            f"data dims {degenerate.tolist()} have zero range — the "
            "normalization ldj log(Δx/δ) would be -inf; drop or jitter "
            "constant dims before building the layer"
        )
    return NormalizationLayer(_f32(lo, device), _f32(hi, device),
                              float(alpha), float(beta))
