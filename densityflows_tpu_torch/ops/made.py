"""MADE: masked autoencoder MLPs for autoregressive conditioners.

PyTorch counterpart of ``densityflows_tpu/ops/made.py``: binary masks over
dense weights enforce the autoregressive property out_i ⟂ in_{≥i} (Germain
et al. 2015), so one masked pass computes every conditional parameter
μ_i(x_{<i}), α_i(x_{<i}).

Conditions θ get degree 0 (visible to every output); feature degrees are
1..d; hidden degrees cycle 1..d−1; outputs connect strictly downstream.

A :class:`MaskedMLP` stores the compact descriptor ``(d, n_cond,
n_params_per_dim, hidden_dims)``, not the masks: they are a pure function of
it (:func:`made_masks`), cached per device and kept out of the module's
parameters and buffers, so a checkpoint holds weights and biases only. The
stored weights are unmasked and the mask is applied as ``w * mask`` on every
call, as in the JAX package: the gradients are zero off the mask and the
checkpoints and Adam moments are the JAX package's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .mlp import ACTIVATIONS

__all__ = ["MaskedMLP", "init_made", "apply_made", "made_masks"]


@functools.lru_cache(maxsize=None)
def made_masks(d: int, n_cond: int, n_params_per_dim: int,
               hidden_dims: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """The MADE mask stack for one descriptor, as read-only float32 numpy
    arrays (one (in_i, out_i) mask per dense layer)."""
    in_deg = np.concatenate([np.zeros(n_cond, np.int64), np.arange(1, d + 1)])
    hi = max(d - 1, 1)
    degs = [in_deg]
    for h in hidden_dims:
        degs.append((np.arange(h) % hi) + 1)
    degs.append(np.repeat(np.arange(1, d + 1), n_params_per_dim))

    masks = []
    n_layers = len(degs) - 1
    for i in range(n_layers):
        if i == n_layers - 1:
            # output layer: strict inequality enforces out_i ⟂ in_{≥i}
            m = (degs[i + 1][:, None] > degs[i][None, :]).T
        else:
            m = (degs[i + 1][:, None] >= degs[i][None, :]).T
        m = np.ascontiguousarray(m, np.float32)
        m.setflags(write=False)
        masks.append(m)
    return tuple(masks)


class MaskedMLP(nn.Module):
    """Dense stack with static binary weight masks (MADE). ``made`` is the
    descriptor ``(d, n_cond, n_params_per_dim, hidden_dims)``."""

    def __init__(self, weights, biases, made, activation: str = "relu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.weights = nn.ParameterList([nn.Parameter(w) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])
        d, n_cond, n_params, hidden = made
        self.made = (int(d), int(n_cond), int(n_params),
                     tuple(int(h) for h in hidden))
        self.activation = activation
        self._mask_cache: dict = {}

    def masks(self, device) -> tuple[torch.Tensor, ...]:
        """The mask stack as float32 tensors on ``device`` (built once per
        device)."""
        device = torch.device(device)
        hit = self._mask_cache.get(device)
        if hit is None:
            hit = tuple(torch.as_tensor(np.array(m)).to(device)
                        for m in made_masks(*self.made))
            self._mask_cache[device] = hit
        return hit

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(w.shape[0]) for w in self.weights) + (
            int(self.weights[-1].shape[1]),)

    def forward(self, h):
        return apply_made(self, h)


def init_made(generator, d: int, n_cond: int, n_params_per_dim: int,
              n_sublayers: int = 2, *, hidden_dim: int = 64,
              activation: str = "relu", zero_final: bool = True,
              device=None) -> MaskedMLP:
    """Masked MLP mapping ``concat([θ, x]) (…, n_cond+d)`` to
    ``(…, d·n_params_per_dim)`` with out[i·P..] depending only on x_{<i} and
    θ. Weights glorot-uniform from ``generator``, the last layer zero when
    ``zero_final``, biases zero."""
    device = resolve_device(device)
    hidden_dims = (int(hidden_dim),) * n_sublayers
    dims = [n_cond + d] + list(hidden_dims) + [d * n_params_per_dim]
    gen_device = generator.device if generator is not None else device
    weights, biases = [], []
    n_layers = len(dims) - 1
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if zero_final and i == n_layers - 1:
            w = torch.zeros(d_in, d_out, device=device)
        else:
            limit = math.sqrt(6.0 / (d_in + d_out))
            u = torch.rand((d_in, d_out), generator=generator,
                           dtype=torch.float32, device=gen_device)
            w = ((2.0 * u - 1.0) * limit).to(device)
        weights.append(w)
        biases.append(torch.zeros(d_out, device=device))
    made = (int(d), int(n_cond), int(n_params_per_dim), hidden_dims)
    return MaskedMLP(weights, biases, made, activation)


def apply_made(net: MaskedMLP, h: torch.Tensor) -> torch.Tensor:
    """(…, n_cond+d) → (…, d·n_params_per_dim), autoregressive in x."""
    act = ACTIVATIONS[net.activation]
    n = len(net.weights)
    a = h
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases,
                                      net.masks(h.device))):
        # in the weights' dtype, as apply_mlp; one cast back at the output
        a = a.to(w.dtype) @ (w * m.to(w.dtype)) + b
        if i < n - 1:
            a = act(a)
    return a.to(h.dtype)
