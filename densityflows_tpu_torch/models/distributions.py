"""Base distributions for flows.

PyTorch counterpart of ``densityflows_tpu/models/distributions.py``. Only
the standard normal is ported so far; the other bases of the JAX package
(diagonal normal, Gaussian mixture, box uniform) are not, and a checkpoint
that holds one fails to load with a clear message.
"""

from __future__ import annotations

import math

import torch

__all__ = ["StandardNormal"]

_LOG_2PI = math.log(2.0 * math.pi)


class StandardNormal:
    """Standard multivariate normal N(0, I_d) — the default base."""

    def __init__(self, d: int):
        self.d = int(d)

    def log_prob(self, z):
        return -0.5 * (self.d * _LOG_2PI + (z * z).sum(-1))

    def sample(self, generator, shape, device):
        """``torch.randn`` draw of shape (*shape, d) on ``device``; the
        generator may live on another device (the draw is then moved)."""
        gen_device = generator.device if generator is not None else device
        r = torch.randn(tuple(shape) + (self.d,), generator=generator,
                        dtype=torch.float32, device=gen_device)
        return r.to(device)
