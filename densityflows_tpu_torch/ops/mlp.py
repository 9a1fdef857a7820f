"""Conditioner MLPs (the s/t networks of coupling layers).

PyTorch counterpart of ``densityflows_tpu/ops/mlp.py``: ``Dense(in→hidden,
σ)`` followed by ``n-1`` hidden ``Dense(hidden→hidden, σ)`` and a final
linear ``Dense(hidden→out)``. Defaults: ``n_sublayers=2``,
``hidden_dim=32``, ``σ=relu``, ``bias=True``.

Weights are stored ``(in, out)`` (row-major activations), the transpose of
``nn.Linear``'s convention, and initialised glorot-uniform — not
``nn.Linear``'s default init. Activations are referenced by name so modules
stay checkpointable.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

__all__ = ["MLP", "init_mlp", "apply_mlp", "ACTIVATIONS", "count_params"]

ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    # the tanh approximation, as jax.nn.gelu's default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "softplus": F.softplus,
    "elu": F.elu,
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """Stack of dense layers. ``weights[i]``: (in_i, out_i); ``biases[i]``:
    (out_i,) or a 0-width placeholder when bias is disabled."""

    def __init__(self, weights, biases, activation: str = "relu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.weights = nn.ParameterList([nn.Parameter(w) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])
        self.activation = activation

    @property
    def dims(self) -> tuple[int, ...]:
        """Layer widths [in, h1, ..., out]."""
        return tuple(int(w.shape[0]) for w in self.weights) + (
            int(self.weights[-1].shape[1]),
        )

    @property
    def has_bias(self) -> bool:
        return bool(len(self.biases)) and bool(self.biases[0].shape[0])

    def forward(self, x):
        return apply_mlp(self, x)


def _glorot_uniform(generator, shape, device):
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device if generator is not None else device)
    return ((2.0 * u - 1.0) * limit).to(device)


def init_mlp(
    generator,
    input_dim: int,
    output_dim: int,
    n_sublayers: int = 2,
    *,
    hidden_dim: int = 32,
    activation: str = "relu",
    bias: bool = True,
    zero_final: bool = False,
    device=None,
) -> MLP:
    """Build an MLP: in→hidden(σ), (n_sublayers-1)×hidden→hidden(σ),
    hidden→out (linear). ``generator``: a ``torch.Generator`` (or None for a
    fresh non-deterministic one).

    ``zero_final=True`` zero-initializes the last dense layer so a coupling
    conditioner outputs s=t=0 at init — the flow starts as the identity.
    """
    if n_sublayers < 1:
        raise ValueError("n_sublayers must be >= 1")
    device = resolve_device(device)
    dims = [input_dim] + [hidden_dim] * n_sublayers + [output_dim]
    n_layers = len(dims) - 1
    weights, biases = [], []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if zero_final and i == n_layers - 1:
            weights.append(torch.zeros(d_in, d_out, device=device))
        else:
            weights.append(_glorot_uniform(generator, (d_in, d_out), device))
        biases.append(torch.zeros(d_out if bias else 0, device=device))
    return MLP(weights, biases, activation)


def apply_mlp(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """Apply the MLP along the last axis: (batch..., in) → (batch..., out).

    Compute runs in the WEIGHTS' dtype: the input is cast once to it, bias
    and activation stay in it between layers, and the output is cast back
    to ``x.dtype`` once at the end (bfloat16 conditioners: bfloat16 products
    forward and backward)."""
    act = ACTIVATIONS[mlp.activation]
    n = len(mlp.weights)
    h = x
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        h = h.to(w.dtype) @ w
        if b.shape[0]:
            h = h + b
        if i < n - 1:  # final layer is linear
            h = act(h)
    return h.to(x.dtype)


def count_params(mlp: MLP) -> int:
    return sum(w.numel() for w in mlp.weights) + sum(
        b.numel() for b in mlp.biases)
