"""Conditioner MLPs (the s/t networks of coupling layers).

PyTorch counterpart of ``densityflows_tpu/ops/mlp.py``: ``Dense(in→hidden,
σ)`` followed by ``n-1`` hidden ``Dense(hidden→hidden, σ)`` and a final
linear ``Dense(hidden→out)``. Defaults: ``n_sublayers=2``,
``hidden_dim=32``, ``σ=relu``, ``bias=True``.

Weights are stored ``(in, out)`` (row-major activations), the transpose of
``nn.Linear``'s convention, and initialised glorot-uniform — not
``nn.Linear``'s default init. Activations are referenced by name so modules
stay checkpointable.

:class:`TensorParallelMLP` is the same network with its layer pairs split
over a mesh's ``model`` axis (``parallel.mesh.shard_params_tp``): Megatron's
column / row parallel pairs, with the two operators as autograd functions
over the axis's process group — before a column-parallel layer the identity
forward and a sum of the input gradient backward, after a row-parallel layer
a sum of the partial products forward and the identity backward.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

__all__ = ["MLP", "TensorParallelMLP", "init_mlp", "apply_mlp", "ACTIVATIONS",
           "count_params"]

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


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the input gradient summed over the
    ``model`` axis backward (each rank's column shard sees part of it)."""

    @staticmethod
    def forward(ctx, h, mesh):
        ctx.mesh = mesh
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_model_(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the row-parallel partial products summed over the
    ``model`` axis forward, identity backward."""

    @staticmethod
    def forward(ctx, h, mesh):
        return mesh.all_reduce_model_(h.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallelMLP(nn.Module):
    """An :class:`MLP` whose layer pairs are split over a mesh's ``model``
    axis: ``weights`` / ``biases`` hold this rank's shards, and
    ``weight_specs`` / ``bias_specs`` say per layer how the full tensor was
    split (``parallel.mesh.mlp_tp_specs``; ``()`` for a replicated one).
    Built by :meth:`shard`; :meth:`gather` joins the shards back."""

    def __init__(self, weights, biases, activation, weight_specs,
                 bias_specs, mesh):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.weights = nn.ParameterList([nn.Parameter(w) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])
        self.activation = activation
        self.weight_specs = tuple(tuple(s) for s in weight_specs)
        self.bias_specs = tuple(tuple(s) for s in bias_specs)
        self.mesh = mesh

    @classmethod
    def shard(cls, mlp: MLP, mesh) -> "TensorParallelMLP":
        """This rank's shards of ``mlp`` (copies). A layer pair whose hidden
        width the ``model`` size does not divide stays replicated, as JAX's
        placement falls back for a dimension it cannot split."""
        from ..parallel.mesh import mlp_tp_specs

        t, m = mesh.model_size, mesh.model_rank
        w_specs, b_specs = mlp_tp_specs(len(mlp.weights))
        for i in range(0, len(w_specs) - 1, 2):
            if mlp.weights[i].shape[1] % t:
                w_specs[i] = w_specs[i + 1] = b_specs[i] = ()

        def part(x, spec):
            if "model" not in spec:
                return x.detach().clone()
            dim = spec.index("model")
            step = x.shape[dim] // t
            return x.detach().narrow(dim, m * step, step).clone()

        return cls([part(w, s) for w, s in zip(mlp.weights, w_specs)],
                   [part(b, s) for b, s in zip(mlp.biases, b_specs)],
                   mlp.activation, w_specs, b_specs, mesh)

    def shard_dims(self) -> list:
        """Per leaf (weights, then biases), the dimension split over the
        ``model`` axis, or None for a replicated leaf."""
        return [s.index("model") if "model" in s else None
                for s in self.weight_specs + self.bias_specs]

    def gather(self) -> MLP:
        """The full :class:`MLP`, the shards joined over the ``model`` axis
        (a collective: every rank of the axis calls it)."""
        leaves = list(self.weights) + list(self.biases)
        full = [t.detach().clone() if dim is None
                else self.mesh.all_gather_model(t.detach(), dim)
                for t, dim in zip(leaves, self.shard_dims())]
        k = len(self.weights)
        return MLP(full[:k], full[k:], self.activation)

    @property
    def dims(self) -> tuple[int, ...]:
        """Layer widths [in, h1, ..., out] of the full network."""
        t = self.mesh.model_size
        dims = [int(self.weights[0].shape[0])]
        for w, spec in zip(self.weights, self.weight_specs):
            dims.append(int(w.shape[1]) * (t if spec == (None, "model")
                                           else 1))
        return tuple(dims)

    @property
    def has_bias(self) -> bool:
        return bool(len(self.biases)) and bool(self.biases[-1].shape[0])

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
    forward and backward). A :class:`TensorParallelMLP` computes its
    column / row pairs on its shards, with one sum over the ``model`` axis
    after each pair."""
    if isinstance(mlp, TensorParallelMLP):
        return _apply_tp(mlp, x)
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


def _apply_tp(mlp: TensorParallelMLP, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[mlp.activation]
    n = len(mlp.weights)
    h = x
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        spec = mlp.weight_specs[i]
        h = h.to(w.dtype)
        if spec == (None, "model"):
            h = _CopyToModel.apply(h, mlp.mesh)
        h = h @ w
        if spec == ("model", None):
            h = _ReduceFromModel.apply(h, mlp.mesh)
        if b.shape[0]:
            h = h + b
        if i < n - 1:  # final layer is linear
            h = act(h)
    return h.to(x.dtype)


def count_params(mlp: MLP) -> int:
    return sum(w.numel() for w in mlp.weights) + sum(
        b.numel() for b in mlp.biases)
