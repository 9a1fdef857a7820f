"""Base distributions for flows.

PyTorch counterpart of ``densityflows_tpu/models/distributions.py``: the
standard normal, a diagonal normal, a mixture of diagonal Gaussians and a
box uniform, each with an analytic ``log_prob`` over the last axis and a
``sample(generator, shape, device)`` drawn from an explicit
``torch.Generator``.

The three parameterized bases are ``nn.Module``s whose tensors are buffers:
they move with ``.to(device)`` (``Flow`` puts its base on the flow's device)
and are never trained — ``Flow`` keeps the base out of the model, as the JAX
package keeps it out of the optimized pytree.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["StandardNormal", "DiagNormal", "GaussianMixture", "BoxUniform"]

_LOG_2PI = math.log(2.0 * math.pi)


def _randn(generator, shape, device):
    """``torch.randn`` of ``shape`` drawn on the generator's device (the
    flow's device without one) and moved to ``device``."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=gen_device).to(device)


class StandardNormal:
    """Standard multivariate normal N(0, I_d) — the default base."""

    def __init__(self, d: int):
        self.d = int(d)

    def log_prob(self, z):
        return -0.5 * (self.d * _LOG_2PI + (z * z).sum(-1))

    def sample(self, generator, shape, device):
        """``torch.randn`` draw of shape (*shape, d) on ``device``; the
        generator may live on another device (the draw is then moved)."""
        return _randn(generator, tuple(shape) + (self.d,), device)


class DiagNormal(nn.Module):
    """Diagonal-covariance normal N(mean, diag(scale²))."""

    def __init__(self, mean, scale):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("scale",
                             torch.as_tensor(scale, dtype=torch.float32))

    @property
    def d(self) -> int:
        return int(self.mean.shape[-1])

    def log_prob(self, z):
        u = (z - self.mean) / self.scale
        return (-0.5 * (self.d * _LOG_2PI + (u * u).sum(-1))
                - torch.log(self.scale).sum(-1))

    def sample(self, generator, shape, device):
        eps = _randn(generator, tuple(shape) + (self.d,), device)
        return self.mean.to(device) + self.scale.to(device) * eps


class GaussianMixture(nn.Module):
    """Mixture of K diagonal Gaussians. ``means`` / ``scales``: (K, d);
    ``logits``: (K,) unnormalized mixture weights."""

    def __init__(self, means, scales, logits):
        super().__init__()
        self.register_buffer("means",
                             torch.as_tensor(means, dtype=torch.float32))
        self.register_buffer("scales",
                             torch.as_tensor(scales, dtype=torch.float32))
        self.register_buffer("logits",
                             torch.as_tensor(logits, dtype=torch.float32))

    @property
    def d(self) -> int:
        return int(self.means.shape[-1])

    @property
    def k(self) -> int:
        return int(self.means.shape[0])

    def log_prob(self, z):
        u = (z[..., None, :] - self.means) / self.scales       # (..., K, d)
        comp = (-0.5 * (self.d * _LOG_2PI + (u * u).sum(-1))
                - torch.log(self.scales).sum(-1))               # (..., K)
        logw = torch.log_softmax(self.logits, -1)
        return torch.logsumexp(comp + logw, dim=-1)

    def sample(self, generator, shape, device):
        """Components from ``torch.multinomial`` over ``softmax(logits)``,
        then the normal draws, both from ``generator``."""
        shape = tuple(shape)
        rows = math.prod(shape)
        gen_device = generator.device if generator is not None else device
        probs = torch.softmax(self.logits, -1).to(gen_device)
        comp = torch.multinomial(probs, rows, replacement=True,
                                 generator=generator).to(device)
        eps = _randn(generator, shape + (self.d,), device)
        mu = self.means.to(device)[comp].reshape(shape + (self.d,))
        sc = self.scales.to(device)[comp].reshape(shape + (self.d,))
        return mu + sc * eps


class BoxUniform(nn.Module):
    """Uniform on the box [lo, hi]^d; ``log_prob`` is -inf outside it (and
    on a NaN row)."""

    def __init__(self, lo, hi):
        super().__init__()
        self.register_buffer("lo", torch.as_tensor(lo, dtype=torch.float32))
        self.register_buffer("hi", torch.as_tensor(hi, dtype=torch.float32))

    @property
    def d(self) -> int:
        return int(self.lo.shape[-1])

    def log_prob(self, z):
        inside = ((z >= self.lo) & (z <= self.hi)).all(-1)
        vol = torch.log(self.hi - self.lo).sum()
        return torch.where(inside, -vol, torch.full_like(vol, -math.inf))

    def sample(self, generator, shape, device):
        gen_device = generator.device if generator is not None else device
        u = torch.rand(tuple(shape) + (self.d,), generator=generator,
                       dtype=torch.float32, device=gen_device).to(device)
        return self.lo.to(device) + (self.hi - self.lo).to(device) * u
