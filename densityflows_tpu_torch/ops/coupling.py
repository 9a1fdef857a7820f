"""Affine-coupling transforms (plain PyTorch path).

PyTorch counterpart of ``densityflows_tpu/ops/coupling.py``:

- forward  (latent z → data x):  x_af = z_af · exp(s) + t,  ldj = +Σ s
- backward (data x → latent z):  z_af = (x_af − t) · exp(−s), ldj = −Σ s
- NICE is the s ≡ 0 volume-preserving special case.
- s, t are conditioner MLPs of ``concat([θ, identity dims])`` (the
  ``axis_nn`` rule, θ first).
- ldj is per-sample with the batch shape.

The split/recombine is expressed as static gathers that autograd
differentiates exactly. Their index tensors are made once per device
(:func:`index_on`): an index given as a Python list would be copied to a
CUDA device on every call, a copy that waits for the device to drain and
that a CUDA graph cannot capture (``train.py``'s graphed steps).
This module is the correctness reference of the whole-chain kernels and
the path of chains they do not take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..axes import CouplingAxes

__all__ = [
    "index_on",
    "take_last",
    "split_features",
    "recombine_features",
    "nn_input",
    "rnvp_forward",
    "rnvp_backward",
    "nice_forward",
    "nice_backward",
]


_INDEX: dict = {}


def index_on(idx, device) -> torch.Tensor:
    """The int64 tensor of the static index ``idx`` on ``device``, made
    once per index and device."""
    key = (tuple(int(i) for i in idx), torch.device(device))
    t = _INDEX.get(key)
    if t is None:
        t = _INDEX[key] = torch.tensor(key[0], dtype=torch.int64,
                                       device=key[1])
    return t


def take_last(x, idx):
    """``x[..., idx]`` for a static index ``idx`` (``index_select`` on the
    last axis, its index tensor from :func:`index_on`)."""
    return x.index_select(x.dim() - 1, index_on(idx, x.device))


def split_features(x, axes: CouplingAxes):
    """Split (batch..., d) into identity and transformed parts along the
    last axis using the static index sets."""
    x_id = take_last(x, axes.axis_id) if axes.axis_id else x[..., :0]
    x_af = take_last(x, axes.axis_af) if axes.axis_af else x[..., :0]
    return x_id, x_af


def _inverse_perm(axes: CouplingAxes) -> list[int]:
    perm = list(axes.axis_id) + list(axes.axis_af)
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    return inv.tolist()


def recombine_features(y_id, y_af, axes: CouplingAxes):
    """Undo :func:`split_features`: place identity/transformed parts back at
    their original feature positions with one static gather."""
    return take_last(torch.cat([y_id, y_af], dim=-1), _inverse_perm(axes))


def nn_input(x_id, theta):
    """Conditioner input: θ first, then the identity dims."""
    return torch.cat([theta, x_id], dim=-1)


def rnvp_forward(s, t, z_af):
    """x_af = z_af·exp(s) + t, ldj = +Σs."""
    return z_af * torch.exp(s) + t, s.sum(-1)


def rnvp_backward(s, t, x_af):
    """z_af = (x_af − t)·exp(−s), ldj = −Σs."""
    return (x_af - t) * torch.exp(-s), -s.sum(-1)


def nice_forward(t, z_af):
    """x_af = z_af + t, ldj = 0."""
    x_af = z_af + t
    return x_af, x_af.new_zeros(x_af.shape[:-1])


def nice_backward(t, x_af):
    """z_af = x_af − t, ldj = 0."""
    z_af = x_af - t
    return z_af, z_af.new_zeros(z_af.shape[:-1])
