"""Coupling layers: RealNVP, joint-conditioner RealNVP, NICE and
rational-quadratic spline, plus the constructor family.

PyTorch counterpart of ``densityflows_tpu/models/layers.py``. Layers are
``nn.Module``s: conditioner-MLP parameters are ``nn.Parameter``s, the
:class:`~densityflows_tpu_torch.axes.CouplingAxes` is a plain static
attribute.

Direction convention: ``forward`` = latent z → data x (sampling),
``inverse`` = data x → latent z (density/training). Both return
``(y, log_det_jac)`` with per-sample ldj of batch shape. ``forward_`` is the
ldj-free sampling path.

Under ``set_fused_kernels(True)`` every RNVP / NICE coupling call takes the
per-layer fused kernels (``ops/coupling_kernels.py``: ``coupling_fwd``, and
``coupling_bwd`` for its gradient), as the JAX layers take their Pallas
kernels. The spline coupling layer has no kernel: it runs in plain PyTorch
under every policy, as in the JAX package.

``cast_conditioners`` casts the conditioner networks (every ``MLP`` /
``MaskedMLP``) to another dtype, bfloat16 by default: ``apply_mlp`` then
computes in bfloat16, while the transform constants stay float32. The
kernels upcast such weights to float32 as they pack them, as the JAX
package's kernels do.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..axes import CouplingAxes, coupling_axes
from ..ops import coupling as C
from ..ops.mlp import (
    MLP, ResidualNet, apply_mlp, count_params, init_mlp, init_residual_net,
)
from ..ops.spline import n_spline_params, rq_spline, rq_spline_nflows
from ..utils.spans import span

__all__ = [
    "RNVPCouplingLayer", "NICECouplingLayer", "JointRNVPCouplingLayer",
    "RQSCouplingLayer", "coupling_layer", "set_fused_kernels",
    "use_fused_chain", "use_fused", "cast_conditioners",
]


def _is_net(module) -> bool:
    from ..ops.made import MaskedMLP
    from ..ops.mlp import TensorParallelMLP

    return isinstance(module, (MLP, MaskedMLP, TensorParallelMLP))


def cast_conditioners(model, dtype=torch.bfloat16):
    """A copy of ``model`` whose conditioner-network parameters (every
    :class:`MLP` / ``MaskedMLP`` subtree) are cast to ``dtype``; transform
    constants (normalization / ActNorm scales, LU factors, logit and spline
    bounds) keep their dtype. The caller's model is not modified.

    :func:`~densityflows_tpu_torch.ops.mlp.apply_mlp` computes in the
    weights' dtype, so bfloat16 conditioners run bfloat16 products while
    s / t / ldj and the loss stay float32. ``train(mixed_precision=True)``
    applies the same cast inside the loss (master parameters, gradients and
    the optimizer state stay float32)."""
    out = copy.deepcopy(model)
    for net in [m for m in out.modules() if _is_net(m)]:
        for sub in net.modules():
            for name, p in list(sub._parameters.items()):
                if p is not None and p.is_floating_point():
                    sub._parameters[name] = nn.Parameter(
                        p.detach().to(dtype), requires_grad=p.requires_grad)
    return out


def _cast_in_graph(model, dtype=torch.bfloat16):
    """``cast_conditioners`` for a loss: a structural copy of ``model`` that
    shares every tensor but the conditioner parameters, which it holds as
    differentiable casts of the originals (gradients flow back to them in
    their own dtype)."""
    def view(module, in_net):
        in_net = in_net or _is_net(module)
        c = copy.copy(module)
        c.__dict__.pop("_fused_plan_cache", None)  # the originals' plans
        c.__dict__.pop("_graph_cache", None)
        c.__dict__["_parameters"] = {
            k: (p.to(dtype) if in_net and p is not None
                and p.is_floating_point() else p)
            for k, p in module._parameters.items()}
        c.__dict__["_modules"] = {k: (view(m, in_net) if m is not None
                                      else None)
                                  for k, m in module._modules.items()}
        return c

    return view(model, False)

# Kernel policy. "auto" routes every fusable chain through the CUDA chain
# kernels when the data is on a CUDA device, and never takes the per-layer
# kernels. True routes on any device (on the CPU the wrappers run their
# plain versions): the chain route comes first, and every RNVP / NICE
# coupling call outside it takes the per-layer coupling kernels. False
# selects the plain per-layer path. The crossover below which the plain
# per-layer path is faster on an H100 has not been measured yet.
_FUSED_MODE: str | bool = "auto"


def set_fused_kernels(mode: str | bool) -> None:
    """Set the kernel policy: "auto" (default), True, or False."""
    global _FUSED_MODE
    if mode not in ("auto", True, False):
        raise ValueError("mode must be 'auto', True, or False")
    _FUSED_MODE = mode


def use_fused_chain(device) -> bool:
    """Whole-chain routing gate for data on ``device``."""
    if _FUSED_MODE is True:
        return True
    if _FUSED_MODE is False:
        return False
    return torch.device(device).type == "cuda"


def use_fused(batch_rows: int) -> bool:
    """Per-layer fused-kernel gate: explicit opt-in only."""
    del batch_rows
    return _FUSED_MODE is True


def _can_fuse_impl(layer, y) -> bool:
    """The per-layer kernels take whole conditioner networks: a layer whose
    nets are tensor-parallel shards (``parallel.mesh.shard_params_tp``)
    stays on the plain path."""
    from ..ops.mlp import TensorParallelMLP

    rows = int(np.prod(y.shape[:-1])) if y.dim() > 1 else 1
    return (use_fused(rows) and layer.axes.nn_input_dim > 0
            and layer.axes.transform_dim > 0
            and not any(isinstance(m, TensorParallelMLP)
                        for m in layer.children()))


def _flatten_batch(y, theta):
    """Collapse leading batch dims to one row axis for the 2-D kernels."""
    batch_shape = y.shape[:-1]
    rows = int(np.prod(batch_shape)) if batch_shape else 1
    return (y.reshape(rows, y.shape[-1]),
            theta.reshape(rows, theta.shape[-1]), batch_shape)


def _fused_apply(layer, s_net, y, theta, direction, with_ldj):
    """The per-layer kernel route: split, conditioner input, one
    ``fused_coupling`` call, recombine."""
    from ..ops.coupling_kernels import fused_coupling

    y2, th2, batch_shape = _flatten_batch(y, theta)
    y_id, y_af = C.split_features(y2, layer.axes)
    h = C.nn_input(y_id, th2)
    out = fused_coupling(s_net, layer.t_net, h, y_af, direction=direction,
                         with_ldj=with_ldj)
    if with_ldj:
        y_out, ldj = out
        y_full = C.recombine_features(y_id, y_out, layer.axes)
        return y_full.reshape(y.shape), ldj.reshape(batch_shape)
    return C.recombine_features(y_id, out, layer.axes).reshape(y.shape)


def _clamp(s, m: float):
    return m * torch.tanh(s / m) if m else s


class RNVPCouplingLayer(nn.Module):
    """Real-NVP affine coupling layer with separate ``s_net`` / ``t_net``.

    ``max_log_scale`` 0.0 = unbounded; > 0 soft-clamps the log-scale to
    (−M, M) via M·tanh(s/M), the guard against exp(s) overflow on
    out-of-distribution inputs.
    """

    def __init__(self, s_net: MLP, t_net: MLP, axes: CouplingAxes,
                 max_log_scale: float = 0.0):
        super().__init__()
        self.s_net, self.t_net = s_net, t_net
        self.axes = axes
        self.max_log_scale = float(max_log_scale)

    def _can_fuse(self, y) -> bool:
        # the kernels implement the unbounded math only
        return _can_fuse_impl(self, y) and not self.max_log_scale

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        h = C.nn_input(y_id, theta)
        s = _clamp(apply_mlp(self.s_net, h), self.max_log_scale)
        return y_id, y_af, s, apply_mlp(self.t_net, h)

    def _fused(self, y, theta, direction, with_ldj):
        return _fused_apply(self, self.s_net, y, theta, direction, with_ldj)

    def forward(self, z, theta):
        if self._can_fuse(z):
            return self._fused(z, theta, "forward", True)
        z_id, z_af, s, t = self._conditioner(z, theta)
        x_af, ldj = C.rnvp_forward(s, t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        if self._can_fuse(x):
            return self._fused(x, theta, "inverse", True)
        x_id, x_af, s, t = self._conditioner(x, theta)
        z_af, ldj = C.rnvp_backward(s, t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        if self._can_fuse(z):
            return self._fused(z, theta, "forward", False)
        z_id, z_af, s, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af * torch.exp(s) + t, self.axes)

    def summarize(self) -> str:
        return (
            f"RNVPCouplingLayer | s_net > {list(self.s_net.dims)} "
            f"({count_params(self.s_net)} parameters)\n"
            f"                  | t_net > {list(self.t_net.dims)} "
            f"({count_params(self.t_net)} parameters)\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


class JointRNVPCouplingLayer(nn.Module):
    """Real-NVP coupling layer with a two-headed conditioner: one MLP emits
    ``(s ‖ t)``. Same coupling math as :class:`RNVPCouplingLayer`; build
    with ``coupling_layer(..., joint_conditioner=True)``."""

    def __init__(self, st_net: MLP, axes: CouplingAxes,
                 max_log_scale: float = 0.0):
        super().__init__()
        self.st_net = st_net
        self.axes = axes
        self.max_log_scale = float(max_log_scale)

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        out = apply_mlp(self.st_net, C.nn_input(y_id, theta))
        a = self.axes.transform_dim
        s, t = out[..., :a], out[..., a:]
        return y_id, y_af, _clamp(s, self.max_log_scale), t

    def forward(self, z, theta):
        z_id, z_af, s, t = self._conditioner(z, theta)
        x_af, ldj = C.rnvp_forward(s, t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        x_id, x_af, s, t = self._conditioner(x, theta)
        z_af, ldj = C.rnvp_backward(s, t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        z_id, z_af, s, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af * torch.exp(s) + t, self.axes)

    def summarize(self) -> str:
        return (
            f"JointRNVPCouplingLayer | st_net > {list(self.st_net.dims)} "
            f"({count_params(self.st_net)} parameters)\n"
            f"                       | axes   > {self.axes.summarize()}"
        )


class NICECouplingLayer(nn.Module):
    """NICE additive (volume-preserving) coupling layer."""

    def __init__(self, t_net: MLP, axes: CouplingAxes):
        super().__init__()
        self.t_net = t_net
        self.axes = axes

    def _can_fuse(self, y) -> bool:
        return _can_fuse_impl(self, y)

    def _conditioner(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        return y_id, y_af, apply_mlp(self.t_net, C.nn_input(y_id, theta))

    def _fused(self, y, theta, direction, with_ldj):
        return _fused_apply(self, None, y, theta, direction, with_ldj)

    def forward(self, z, theta):
        if self._can_fuse(z):
            return self._fused(z, theta, "forward", True)
        z_id, z_af, t = self._conditioner(z, theta)
        x_af, ldj = C.nice_forward(t, z_af)
        return C.recombine_features(z_id, x_af, self.axes), ldj

    def inverse(self, x, theta):
        if self._can_fuse(x):
            return self._fused(x, theta, "inverse", True)
        x_id, x_af, t = self._conditioner(x, theta)
        z_af, ldj = C.nice_backward(t, x_af)
        return C.recombine_features(x_id, z_af, self.axes), ldj

    def forward_(self, z, theta):
        if self._can_fuse(z):
            return self._fused(z, theta, "forward", False)
        z_id, z_af, t = self._conditioner(z, theta)
        return C.recombine_features(z_id, z_af + t, self.axes)

    def summarize(self) -> str:
        return (
            f"NICECouplingLayer | t_net > {list(self.t_net.dims)} "
            f"({count_params(self.t_net)} parameters)\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


class RQSCouplingLayer(nn.Module):
    """Rational-quadratic spline coupling layer (Neural Spline Flows,
    Durkan et al. 2019; see ``ops/spline.py``). The conditioner maps
    (θ ⊕ identity dims) to ``3K−1`` raw spline parameters per transformed
    dim; the elementwise monotone spline acts on ``[-bound, bound]`` with
    identity tails.

    ``p_net`` is an :class:`~..ops.mlp.MLP` of ``[θ ; x_id]`` or a
    :class:`~..ops.mlp.ResidualNet` of ``x_id`` with θ as its context.
    ``spline_on`` says which direction evaluates the spline's closed form:
    ``"sample"`` (latent → data; the density solves for the root, as the
    JAX package does) or ``"density"`` (nflows' coupling transform: its
    closed form data → latent, sampling solves for the root, in nflows'
    arithmetic, ``ops/spline.py::rq_spline_nflows``). ``bin_divisor`` divides the
    raw widths and heights before their softmax (nflows: √hidden for a
    ``ResidualNet``). Each spline evaluation records a ``df.spline`` span
    (``elems``: the transformed elements)."""

    def __init__(self, p_net, axes: CouplingAxes, n_bins: int = 8,
                 bound: float = 3.0, *, spline_on: str = "sample",
                 bin_divisor: float = 1.0):
        super().__init__()
        if spline_on not in ("sample", "density"):
            raise ValueError(
                f"spline_on must be 'sample' or 'density', got {spline_on!r}")
        self.p_net = p_net
        self.axes = axes
        self.n_bins = int(n_bins)
        self.bound = float(bound)
        self.spline_on = spline_on
        self.bin_divisor = float(bin_divisor)

    def _params(self, y, theta):
        y_id, y_af = C.split_features(y, self.axes)
        if isinstance(self.p_net, ResidualNet):
            raw = self.p_net(y_id, theta)
        else:
            raw = apply_mlp(self.p_net, C.nn_input(y_id, theta))
        raw = raw.reshape(raw.shape[:-1] + (self.axes.transform_dim,
                                            n_spline_params(self.n_bins)))
        if self.bin_divisor != 1.0:
            k2 = 2 * self.n_bins
            raw = torch.cat([raw[..., :k2] / self.bin_divisor,
                             raw[..., k2:]], -1)
        return y_id, y_af, raw

    def _spline(self, y_af, raw, toward_data, with_ldj=True):
        """The spline latent → data (``toward_data``) or data → latent."""
        inverse = toward_data != (self.spline_on == "sample")
        spline = rq_spline if self.spline_on == "sample" else rq_spline_nflows
        with span("df.spline") as s:
            if s.recording:
                s.counts["elems"] = y_af.numel()
            return spline(y_af, raw, bound=self.bound, inverse=inverse,
                          with_ldj=with_ldj)

    def _transform(self, y, theta, toward_data):
        y_id, y_af, raw = self._params(y, theta)
        out, ldj_e = self._spline(y_af, raw, toward_data)
        return C.recombine_features(y_id, out, self.axes), ldj_e.sum(-1)

    def forward(self, z, theta):
        return self._transform(z, theta, True)

    def inverse(self, x, theta):
        return self._transform(x, theta, False)

    def forward_(self, z, theta):
        """ldj-free sampling path (``rq_spline(with_ldj=False)``)."""
        z_id, z_af, raw = self._params(z, theta)
        x_af, _ = self._spline(z_af, raw, True, with_ldj=False)
        return C.recombine_features(z_id, x_af, self.axes)

    def summarize(self) -> str:
        return (
            f"RQSCouplingLayer  | p_net > {list(self.p_net.dims)} "
            f"({count_params(self.p_net)} parameters, K={self.n_bins}, "
            f"bound={self.bound}"
            + (", spline on density" if self.spline_on == "density" else "")
            + ")\n"
            f"                  | axes  > {self.axes.summarize()}"
        )


def coupling_layer(
    d_or_axes_or_data,
    mask: Sequence[int] | int | None = None,
    *,
    kind: type = RNVPCouplingLayer,
    n: int = 0,
    reverse: bool = False,
    generator: torch.Generator | None = None,
    n_sublayers_s: int = 2,
    n_sublayers_t: int = 2,
    hidden_dim_s: int = 32,
    hidden_dim_t: int = 32,
    activation_s: str = "relu",
    activation_t: str = "relu",
    bias: bool = True,
    zero_init_final: bool = True,
    max_log_scale: float = 0.0,
    joint_conditioner: bool = False,
    n_bins: int = 8,
    bound: float = 3.0,
    conditioner: str = "mlp",
    batch_norm: bool = False,
    spline_on: str = "sample",
    device=None,
):
    """Build a coupling layer with default conditioner MLPs.

    The first argument is a :class:`CouplingAxes`, an ``int`` dimension
    ``d`` (with ``mask`` = index list or split point, default ``d // 2``),
    or a :class:`~densityflows_tpu_torch.data.DataArrays` (d and n
    inferred). Defaults: 2 sublayers, hidden 32, relu, bias on. Conditioner
    input width = ``len(axis_nn)``, output width = ``len(axis_af)``.

    ``zero_init_final=True`` zero-initializes each conditioner's last dense
    layer, so every coupling layer is the identity at init.
    ``joint_conditioner=True`` (RNVP only) builds a
    :class:`JointRNVPCouplingLayer`; the s/t hyperparameters must agree.
    ``max_log_scale`` (RNVP only, default 0 = off) soft-clamps the
    log-scale to (−M, M) via ``M·tanh(s/M)``. ``kind=RQSCouplingLayer``
    builds a spline coupling of ``n_bins`` bins on ``[-bound, bound]`` whose
    one conditioner takes the t-net hyperparameters, its closed form in the
    direction ``spline_on`` (see :class:`RQSCouplingLayer`).

    ``conditioner="residual"`` (spline couplings only) makes that
    conditioner nflows' residual net (``ops/mlp.py::ResidualNet``):
    ``n_sublayers_t`` residual blocks of width ``hidden_dim_t`` with
    ``activation_t``, θ as the context of the first layer and of every
    block's gate, :class:`~..ops.mlp.BatchNorm` in the blocks with
    ``batch_norm``, initialised as nflows initialises it (``zero_init_final``
    zeroes its output layer), and the raw bin widths and heights divided by
    √``hidden_dim_t`` as nflows divides them.
    """
    from ..data import DataArrays  # local import to avoid a cycle

    if isinstance(d_or_axes_or_data, CouplingAxes):
        axes = d_or_axes_or_data
    elif isinstance(d_or_axes_or_data, DataArrays):
        data = d_or_axes_or_data
        axes = coupling_axes(
            data.num_dimensions, mask, n=data.num_conditions, reverse=reverse
        )
    else:
        axes = coupling_axes(int(d_or_axes_or_data), mask, n=n, reverse=reverse)

    device = resolve_device(device)
    in_dim, out_dim = axes.nn_input_dim, axes.transform_dim

    def net(out, n_sub, hidden, act):
        return init_mlp(generator, in_dim, out, n_sub, hidden_dim=hidden,
                        activation=act, bias=bias,
                        zero_final=zero_init_final, device=device)

    if joint_conditioner:
        if kind is not RNVPCouplingLayer:
            raise ValueError(
                "joint_conditioner=True is an RNVP parameterization "
                f"(got kind={kind.__name__})"
            )
        if (n_sublayers_s, hidden_dim_s, activation_s) != (
            n_sublayers_t, hidden_dim_t, activation_t
        ):
            raise ValueError(
                "joint_conditioner=True uses ONE net for both heads — "
                "the s/t hyperparameters must agree "
                f"(got s=({n_sublayers_s}, {hidden_dim_s}, {activation_s!r}) "
                f"vs t=({n_sublayers_t}, {hidden_dim_t}, {activation_t!r}))"
            )
        st_net = net(2 * out_dim, n_sublayers_s, hidden_dim_s, activation_s)
        return JointRNVPCouplingLayer(st_net, axes, float(max_log_scale))
    if kind is NICECouplingLayer:
        return NICECouplingLayer(
            net(out_dim, n_sublayers_t, hidden_dim_t, activation_t), axes)
    if conditioner not in ("mlp", "residual"):
        raise ValueError(
            f"conditioner must be 'mlp' or 'residual', got {conditioner!r}")
    if (conditioner == "residual" or batch_norm) \
            and kind is not RQSCouplingLayer:
        raise ValueError(
            "conditioner='residual' and batch_norm are options of the spline "
            f"coupling (kind=RQSCouplingLayer), got kind={kind.__name__}")
    if batch_norm and conditioner != "residual":
        raise ValueError("batch_norm needs conditioner='residual'")
    if kind is RQSCouplingLayer:
        n_out = out_dim * n_spline_params(n_bins)
        if conditioner == "residual":
            p_net = init_residual_net(
                generator, len(axes.axis_id), n_out, axes.n,
                hidden_dim=hidden_dim_t, n_blocks=n_sublayers_t,
                activation=activation_t, batch_norm=batch_norm,
                zero_final=zero_init_final, device=device)
            divisor = float(np.sqrt(hidden_dim_t))
        else:
            p_net = net(n_out, n_sublayers_t, hidden_dim_t, activation_t)
            divisor = 1.0
        return RQSCouplingLayer(p_net, axes, n_bins, float(bound),
                                spline_on=spline_on, bin_divisor=divisor)
    if kind is not RNVPCouplingLayer:
        raise NotImplementedError(
            f"coupling kind {getattr(kind, '__name__', kind)} is not a "
            "coupling of this package (RNVPCouplingLayer, NICECouplingLayer "
            "or RQSCouplingLayer)")
    s_net = net(out_dim, n_sublayers_s, hidden_dim_s, activation_s)
    t_net = net(out_dim, n_sublayers_t, hidden_dim_t, activation_t)
    return RNVPCouplingLayer(s_net, t_net, axes, float(max_log_scale))
