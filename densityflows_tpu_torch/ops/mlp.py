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

:class:`ResidualNet` is nflows' ``ResidualNet`` (Durkan et al., "Neural
Spline Flows", 2019), the conditioner of Dingo's spline couplings: a linear
layer of ``[x ; context]``, residual blocks whose branch is gated by the
context, a linear output layer. Its blocks may hold :class:`BatchNorm`
layers, whose running statistics are buffers: they normalise by those
statistics, and by the batch's own only inside :func:`batch_statistics`
(the plain training program's batch losses).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

__all__ = ["MLP", "TensorParallelMLP", "init_mlp", "apply_mlp", "ACTIVATIONS",
           "count_params", "BatchNorm", "ResidualBlock", "ResidualNet",
           "init_residual_net", "batch_statistics", "has_batch_norm"]

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


def count_params(mlp) -> int:
    return sum(p.numel() for p in mlp.parameters())


class BatchNorm(nn.Module):
    """``nn.BatchNorm1d`` over the last axis: ``weight`` (γ) and ``bias`` (β)
    are parameters, ``running_mean`` / ``running_var`` buffers. It starts in
    eval mode (the running statistics); in train mode (see
    :func:`batch_statistics`) it normalises by the batch's mean and biased
    variance and moves the running statistics by ``momentum`` towards the
    batch's mean and unbiased variance."""

    def __init__(self, weight, bias, running_mean, running_var, *,
                 eps: float = 1e-3, momentum: float = 0.1):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.register_buffer("running_mean", running_mean)
        self.register_buffer("running_var", running_var)
        self.eps, self.momentum = float(eps), float(momentum)
        self.train(False)

    def forward(self, x):
        rows = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
        out = F.batch_norm(rows, self.running_mean, self.running_var,
                           self.weight, self.bias, self.training,
                           self.momentum, self.eps)
        return out if x.dim() == 2 else out.reshape(x.shape)


def has_batch_norm(model) -> bool:
    return any(isinstance(m, BatchNorm) for m in model.modules())


@contextlib.contextmanager
def batch_statistics(model):
    """Every :class:`BatchNorm` of ``model`` in train mode for the block (the
    batch's statistics, running statistics updated), then back to its mode
    before."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.training for m in norms]
    for m in norms:
        m.train(True)
    try:
        yield
    finally:
        for m, mode in zip(norms, before):
            m.train(mode)


class ResidualBlock(nn.Module):
    """``t = W1 σ(BN1(W0 σ(BN0(h)) + b0)) + b1``, then ``h + t ⊙ sigmoid(Wc c
    + bc)`` (nflows' ``ResidualBlock`` with its GLU context gate; no gate
    without a context, no norms without batch norm). Weights (in, out)."""

    def __init__(self, w0, b0, w1, b1, wc=None, bc=None, norms=None):
        super().__init__()
        self.norms = nn.ModuleList(norms or [])
        self.w0, self.b0 = nn.Parameter(w0), nn.Parameter(b0)
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.wc = nn.Parameter(wc) if wc is not None else None
        self.bc = nn.Parameter(bc) if bc is not None else None

    def forward(self, h, context, act):
        t = self.norms[0](h) if len(self.norms) else h
        t = act(t) @ self.w0 + self.b0
        if len(self.norms):
            t = self.norms[1](t)
        t = act(t) @ self.w1 + self.b1
        if self.wc is not None:
            t = t * torch.sigmoid(context @ self.wc + self.bc)
        return h + t


class ResidualNet(nn.Module):
    """nflows' ``ResidualNet``: ``h = W_in [x ; c] + b_in``, the residual
    blocks, ``W_out h + b_out``. Weights (in, out)."""

    def __init__(self, w_in, b_in, blocks, w_out, b_out,
                 activation: str = "relu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.w_in, self.b_in = nn.Parameter(w_in), nn.Parameter(b_in)
        self.blocks = nn.ModuleList(blocks)
        self.w_out, self.b_out = nn.Parameter(w_out), nn.Parameter(b_out)
        self.activation = activation

    @property
    def hidden_features(self) -> int:
        return int(self.w_in.shape[1])

    @property
    def dims(self) -> tuple[int, ...]:
        """Widths [in + context, hidden, out]."""
        return (int(self.w_in.shape[0]), self.hidden_features,
                int(self.w_out.shape[1]))

    def forward(self, x, context):
        act = ACTIVATIONS[self.activation]
        h = torch.cat([x, context], dim=-1) @ self.w_in + self.b_in
        for block in self.blocks:
            h = block(h, context, act)
        return h @ self.w_out + self.b_out


def init_residual_net(generator, in_features: int, out_features: int,
                      context_features: int, *, hidden_dim: int = 32,
                      n_blocks: int = 2, activation: str = "relu",
                      batch_norm: bool = False, zero_final: bool = False,
                      device=None) -> ResidualNet:
    """A :class:`ResidualNet` initialised as nflows initialises it: every
    linear layer ``nn.Linear``'s uniform ±1/√fan_in (weights and biases),
    each block's second one ±1e-3; batch norm γ = 1, β = 0, running mean 0
    and variance 1 (eps 1e-3, momentum 0.1). ``zero_final=True`` zeroes the
    output layer. A zero-width context has no gates."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else device

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=gdev)
        return ((2.0 * u - 1.0) * bound).to(device)

    def linear(d_in, d_out, bound=None):
        bound = 1.0 / math.sqrt(d_in) if bound is None else bound
        return uniform((d_in, d_out), bound), uniform((d_out,), bound)

    h = int(hidden_dim)
    w_in, b_in = linear(in_features + context_features, h)
    blocks = []
    for _ in range(int(n_blocks)):
        norms = [BatchNorm(torch.ones(h, device=device),
                           torch.zeros(h, device=device),
                           torch.zeros(h, device=device),
                           torch.ones(h, device=device))
                 for _ in range(2)] if batch_norm else None
        w0, b0 = linear(h, h)
        w1, b1 = linear(h, h, 1e-3)
        wc, bc = (linear(context_features, h) if context_features
                  else (None, None))
        blocks.append(ResidualBlock(w0, b0, w1, b1, wc, bc, norms))
    if zero_final:
        w_out = torch.zeros(h, out_features, device=device)
        b_out = torch.zeros(out_features, device=device)
    else:
        w_out, b_out = linear(h, out_features)
    return ResidualNet(w_in, b_in, blocks, w_out, b_out, activation)
