"""Whole-chain fusion: compile a FlowChain into one kernel pass.

PyTorch counterpart of ``densityflows_tpu/models/fused_chain.py``. Builds the
static op *plan* + flat parameter list that ``ops/chain_kernels.py``
executes, and wraps the kernel in a ``torch.autograd.Function`` whose
backward recomputes through the plain per-layer path — so the fused chain is
safe to call under autograd while targeting the inference paths: the
sampling sweep and density evaluation.

Supported elements: RNVP / joint-RNVP / NICE couplings, Normalization,
ActNorm, Permutation, InvertibleLinear (LU), Logit, and CouplingBlocks of
these. A chain containing anything else (a spline coupling, a MAF / IAF
layer) is not fusable, and neither is a chain whose conditioners are
tensor-parallel (``parallel.mesh.shard_params_tp``: the kernels hold whole
networks, a rank holds shards):
:func:`maybe_apply_fused` returns ``None`` and the caller keeps the
per-layer path. A chain of these layers that the kernels cannot run
(a parameter that is not float32, but for bfloat16 conditioners, which are
upcast as they are packed; on CUDA, a hidden width past the kernels'
shared-memory limit) raises instead of giving way to the per-layer path.

Routing: ``set_fused_kernels("auto")`` sends every fusable chain whose data
is on a CUDA device through the kernels; nothing is caught on the way — a
build or launch failure propagates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import coupling as C
from ..ops.mlp import TensorParallelMLP
from ..ops.chain_kernels import (
    op_param_count,
    pack_plan,
    pick_tile_rows,
    run_chain,
    run_chain_sample,
)
from .blocks import CouplingBlock
from .glow import ActNormLayer, InvertibleLinearLayer
from .layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
    use_fused_chain,
)
from .normalization import LogitLayer, NormalizationLayer, PermutationLayer

__all__ = ["maybe_apply_fused", "maybe_sample_fused", "chain_is_fusable",
           "fold_layers", "fused_plan", "apply_fused", "sample_fused"]

_COUPLINGS = (RNVPCouplingLayer, NICECouplingLayer, JointRNVPCouplingLayer)
# every element type the kernels' plan covers
_PLAN_TYPES = _COUPLINGS + (InvertibleLinearLayer, NormalizationLayer,
                            ActNormLayer, PermutationLayer, LogitLayer)


class _Unsupported(Exception):
    pass


def _inv_perm(perm):
    inv = np.empty(len(perm), np.int64)
    inv[list(perm)] = np.arange(len(perm))
    return tuple(int(i) for i in inv)


def _perm_matrix(perm, d, device):
    """(d, d) with m[perm[j], j] = 1 so that (x @ m)[:, j] = x[:, perm[j]]."""
    m = np.zeros((d, d), np.float32)
    for j, i in enumerate(perm):
        m[int(i), j] = 1.0
    return torch.as_tensor(m).to(device)


def _fold_first(w0, ax, params):
    """First dense layer (K, H), K = n + |id|, split into a θ part (n, H)
    and an x part zero-padded to (d, H): ``θ@W1θ + x@W1x`` reproduces
    ``[θ | x[:, id]] @ W1`` since the zero rows kill non-identity dims."""
    n = ax.n
    if n:
        params.append(w0[:n])
    if ax.axis_id:
        w1x = w0.new_zeros(ax.d, w0.shape[1])
        w1x[list(ax.axis_id)] = w0[n:]
        params.append(w1x)


def _scatter_cols(w, ax):
    """(H, A) → (H, d) with the columns at the af positions."""
    out = w.new_zeros(w.shape[0], ax.d)
    out[:, list(ax.axis_af)] = w
    return out


def _f32(t):
    """A conditioner tensor for the kernels: detached, bfloat16 upcast to
    float32 as the JAX package's packers upcast it."""
    return t.detach().float()


def _coupling_entry(layer, dirn):
    """Fold the static split/recombine into the conditioner weights so the
    kernel does no selection work: the final dense layer (H, A) scatters
    into (H, d) columns at af positions (bias likewise), so the net emits
    d-wide s/t that are exactly 0 on identity dims and the elementwise
    ``y = x·exp(s_full) + t_full`` is the whole coupling."""
    if isinstance(layer, JointRNVPCouplingLayer):
        return _joint_coupling_entry(layer, dirn)
    if isinstance(layer, RNVPCouplingLayer):
        kind, nets = "nvp", (layer.s_net, layer.t_net)
    else:
        kind, nets = "nice", (None, layer.t_net)
    s_net, t_net = nets
    ax = layer.axes
    if ax.transform_dim == 0 or ax.nn_input_dim == 0:
        raise _Unsupported  # degenerate masks keep the per-layer path
    params = []

    def fold_net(net):
        ws = [_f32(w) for w in net.weights]
        if len(ws) < 2:
            raise _Unsupported
        _fold_first(ws[0], ax, params)
        params.extend(ws[1:-1])
        params.append(_scatter_cols(ws[-1], ax))
        if net.has_bias:
            for b in list(net.biases)[:-1]:
                params.append(_f32(b).reshape(1, -1))
            params.append(_scatter_cols(_f32(net.biases[-1])[None], ax))
        return len(ws), net.activation, net.has_bias

    if kind == "nvp":
        n_s, act_s, bias_s = fold_net(s_net)
    else:
        n_s, act_s, bias_s = 0, "identity", False
    n_t, act_t, bias_t = fold_net(t_net)
    clamp = float(getattr(layer, "max_log_scale", 0.0))
    op = ("coupling", kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t,
          ax.n > 0, len(ax.axis_id) > 0, clamp)
    return op, params


def _joint_coupling_entry(layer, dirn):
    """Joint (two-headed) coupling: the shared stack folds like a plain net,
    but the final (H, 2|af|) weight splits into two (H, d) folded heads."""
    net = layer.st_net
    ax = layer.axes
    if ax.transform_dim == 0 or ax.nn_input_dim == 0:
        raise _Unsupported
    a = ax.transform_dim
    ws = [_f32(w) for w in net.weights]
    n_layers = len(ws)
    if n_layers < 2:
        raise _Unsupported  # a single dense layer has no shared stack
    params = []
    _fold_first(ws[0], ax, params)
    params.extend(ws[1:-1])
    wf = ws[-1]  # (H, 2a): columns [:a] are the s head, [a:] the t head
    params.append(_scatter_cols(wf[:, :a], ax))
    params.append(_scatter_cols(wf[:, a:], ax))
    if net.has_bias:
        for b in list(net.biases)[:-1]:
            params.append(_f32(b).reshape(1, -1))
        bf = _f32(net.biases[-1])[None]
        params.append(_scatter_cols(bf[:, :a], ax))
        params.append(_scatter_cols(bf[:, a:], ax))
    op = ("coupling", "joint", dirn, n_layers, 0, net.activation,
          net.activation, net.has_bias, False, ax.n > 0,
          len(ax.axis_id) > 0, float(layer.max_log_scale))
    return op, params


def _normalization_entry(layer, dirn):
    lo, hi = layer.x_min.detach(), layer.x_max.detach()
    diff = hi - lo
    delta = layer.beta - layer.alpha
    c = torch.log(diff / delta).sum().reshape(1, 1)
    if dirn == "fwd":  # [α,β] → [lo,hi]
        a = diff / delta
        b = (layer.beta * lo - layer.alpha * hi) / delta
        return ("affine",), [a.reshape(1, -1), b.reshape(1, -1), c]
    a = delta / diff  # [lo,hi] → [α,β]
    b = (layer.alpha * hi - layer.beta * lo) / diff
    return ("affine",), [a.reshape(1, -1), b.reshape(1, -1), -c]


def _actnorm_entry(layer, dirn):
    ls, bias = layer.log_scale.detach(), layer.bias.detach()
    c = ls.sum().reshape(1, 1)
    if dirn == "fwd":  # x = z·e⁻ˢ + b
        a = torch.exp(-ls)
        return ("affine",), [a.reshape(1, -1), bias.reshape(1, -1), -c]
    a = torch.exp(ls)  # z = (x − b)·eˢ
    return ("affine",), [a.reshape(1, -1), (-bias * a).reshape(1, -1), c]


def _invlinear_entry(layer, dirn):
    with torch.no_grad():
        c = layer.log_s.sum().reshape(1, 1)
        if dirn == "inv":  # z = x @ Wᵀ
            return ("linear",), [layer._w().T.contiguous(), c]
        # forward: x = z @ W⁻ᵀ; W⁻¹ = U⁻¹ L⁻¹ Π with Π y = y[inv_perm]
        l, u = layer._lu()
        e = torch.eye(layer.d, dtype=l.dtype,
                      device=l.device)[list(layer._inv_perm()), :]
        w_inv = torch.linalg.solve_triangular(
            u, torch.linalg.solve_triangular(l, e, upper=False,
                                             unitriangular=True),
            upper=True)
        return ("linear",), [w_inv.T.contiguous(), -c]


def _logit_entry(layer, dirn):
    lo = layer.lo.detach().reshape(1, -1)
    hi = layer.hi.detach().reshape(1, -1)
    return ("logit", dirn, float(layer.eps)), [lo, hi, torch.log(hi - lo)]


def _entry(layer, dirn, device):
    if isinstance(layer, _COUPLINGS):
        return _coupling_entry(layer, dirn)
    if isinstance(layer, NormalizationLayer):
        return _normalization_entry(layer, dirn)
    if isinstance(layer, ActNormLayer):
        return _actnorm_entry(layer, dirn)
    if isinstance(layer, InvertibleLinearLayer):
        return _invlinear_entry(layer, dirn)
    if isinstance(layer, PermutationLayer):
        d = len(layer.perm)
        zero = torch.zeros(1, 1, device=device)
        perm = layer.perm if dirn == "fwd" else _inv_perm(layer.perm)
        return ("linear",), [_perm_matrix(perm, d, device), zero]
    if isinstance(layer, LogitLayer):
        return _logit_entry(layer, dirn)
    raise _Unsupported(_outside(layer))


def _outside(layer) -> str:
    return (f"{type(layer).__name__} is outside the chain kernels' plan "
            "(RNVP/joint/NICE couplings + Normalization/ActNorm/"
            "InvertibleLinear/Permutation/Logit only)")


def _iter_layers(chain, dirn):
    # blocks may nest one level (CouplingBlock holds layer_1/layer_2)
    seq = list(chain.layers)
    if dirn != "fwd":
        seq.reverse()
    for layer in seq:
        if isinstance(layer, CouplingBlock):
            pair = (layer.layer_1, layer.layer_2)
            yield from pair if dirn == "fwd" else reversed(pair)
        else:
            yield layer


def _chain_device(chain):
    for t in chain.parameters():
        return t.device
    for t in chain.buffers():
        return t.device
    return torch.device("cpu")


def _plan_params(chain, dirn):
    """The plan (tuple of op descriptors) and its flat list of folded f32
    parameter tensors, detached, on the chain's device."""
    device = _chain_device(chain)
    plan, params = [], []
    for layer in _iter_layers(chain, dirn):
        op, p = _entry(layer, dirn, device)
        if len(p) != op_param_count(op):
            raise AssertionError(f"{op}: {len(p)} params")
        plan.append(op)
        params.extend(p)
    if not plan:
        raise _Unsupported
    return tuple(plan), params


def _conditioner_nets(layer):
    if isinstance(layer, RNVPCouplingLayer):
        return (layer.s_net, layer.t_net)
    if isinstance(layer, NICECouplingLayer):
        return (layer.t_net,)
    if isinstance(layer, JointRNVPCouplingLayer):
        return (layer.st_net,)
    return ()


def _max_hidden(chain) -> int:
    """Widest conditioner hidden layer."""
    h = 0
    for layer in _iter_layers(chain, "fwd"):
        for net in _conditioner_nets(layer):
            for w in list(net.weights)[:-1]:
                h = max(h, int(w.shape[-1]))
    return h


def chain_is_fusable(chain, d: int, n: int) -> bool:
    """Whether the kernels cover every layer type of the chain. A chain of
    covered layers that breaks a limit of the kernels (dtype, width) is
    fusable all the same: routing it raises, see
    :func:`_require_kernel_limits`."""
    for layer in _iter_layers(chain, "fwd"):
        if isinstance(layer, _COUPLINGS):
            if layer.axes.transform_dim == 0 or layer.axes.nn_input_dim == 0:
                return False
            if layer.axes.d != d or layer.axes.n != n:
                return False
            if any(len(net.weights) < 2 for net in _conditioner_nets(layer)):
                return False
            if any(isinstance(net, TensorParallelMLP)
                   for net in _conditioner_nets(layer)):
                return False
        elif not isinstance(layer, _PLAN_TYPES):
            return False
    return bool(len(chain.layers))


def _require_kernel_limits(chain, d: int, n: int, device) -> None:
    """Raise for a fusable chain the kernels cannot run: conditioner
    parameters that are neither float32 nor bfloat16 (bfloat16 ones are
    upcast as they are packed), other parameters that are not float32, or,
    for a CUDA device, a hidden width whose smallest row tile does not fit a
    block's shared memory."""
    nets = {id(p) for layer in _iter_layers(chain, "fwd")
            for net in _conditioner_nets(layer) for p in net.parameters()}
    for name, t in chain.named_parameters():
        ok = ((torch.float32, torch.bfloat16) if id(t) in nets
              else (torch.float32,))
        if t.dtype not in ok:
            raise TypeError(
                f"the chain kernels are float32 only (bfloat16 conditioners "
                f"are upcast): parameter {name} is {t.dtype} "
                "(set_fused_kernels(False) selects the per-layer path)")
    if torch.device(device).type == "cuda":
        hmax4 = (_max_hidden(chain) + 3) & ~3
        pick_tile_rows(d, n, hmax4 + 4 if hmax4 else 0)


# -- cached plans ------------------------------------------------------------

def _state_key(chain):
    return tuple((t.data_ptr(), t._version, t.device)
                 for t in list(chain.parameters()) + list(chain.buffers()))


def _cached_plan(chain, dirn, d, n):
    """``(plan, params, packed), hit`` for the chain's current weights. The
    folded parameters (and, on CUDA, their packed form) are rebuilt only
    when a parameter or buffer of the chain changed; ``hit`` is 1 where
    they were not, else 0."""
    cache = chain.__dict__.setdefault("_fused_plan_cache", {})
    key = _state_key(chain)
    entry = cache.get(dirn)
    if entry is not None and entry[0] == key:
        return entry[1:], 1
    with torch.no_grad():
        plan, params = _plan_params(chain, dirn)
        packed = (pack_plan(plan, params, d, n)
                  if params[0].device.type == "cuda" else None)
    cache[dirn] = (key, plan, params, packed)
    return (plan, params, packed), 0


# -- the plain per-layer fold (reference and backward path) -------------------

def _layer_plain(layer, y, theta, dirn):
    """One layer in plain PyTorch with ldj: RNVP and NICE couplings bypass
    their own per-layer kernel dispatch (``set_fused_kernels(True)``)."""
    if isinstance(layer, RNVPCouplingLayer):
        y_id, y_af, s, t = layer._conditioner(y, theta)
        out, ldj = (C.rnvp_forward(s, t, y_af) if dirn == "fwd"
                    else C.rnvp_backward(s, t, y_af))
        return C.recombine_features(y_id, out, layer.axes), ldj
    if isinstance(layer, NICECouplingLayer):
        y_id, y_af, t = layer._conditioner(y, theta)
        out, ldj = (C.nice_forward(t, y_af) if dirn == "fwd"
                    else C.nice_backward(t, y_af))
        return C.recombine_features(y_id, out, layer.axes), ldj
    return layer.forward(y, theta) if dirn == "fwd" else layer.inverse(y, theta)


def fold_layers(chain, y, theta, dirn, with_ldj):
    """Per-layer plain fold of the chain; never routes to a kernel, whatever
    the policy (the reference of the chain kernels and their backward). A
    layer the kernels do not cover (a spline coupling, a MAF / IAF layer) is
    declined by name: ``_Unsupported`` names it."""
    ldj = None
    for layer in _iter_layers(chain, dirn):
        if not isinstance(layer, _PLAN_TYPES):
            raise _Unsupported(_outside(layer))
        if not with_ldj and dirn == "fwd" and not isinstance(
                layer, (RNVPCouplingLayer, NICECouplingLayer)):
            y = layer.forward_(y, theta)
            continue
        y, ldj_i = _layer_plain(layer, y, theta, dirn)
        ldj = ldj_i if ldj is None else ldj + ldj_i
    return (y, ldj) if with_ldj else y


class _ChainFused(torch.autograd.Function):
    """``chain_apply`` forward; the backward recomputes through the plain
    per-layer path (the kernel has no backward kernel, as on the TPU)."""

    @staticmethod
    def forward(ctx, chain, dirn, with_ldj, cached, x2, th2, *chain_params):
        plan, params, packed = cached
        out = run_chain(plan, params, x2, th2, with_ldj=with_ldj,
                        packed=packed)
        ctx.chain, ctx.dirn, ctx.with_ldj = chain, dirn, with_ldj
        ctx.save_for_backward(x2, th2)
        return out

    @staticmethod
    def backward(ctx, *grads):
        x2, th2 = ctx.saved_tensors
        chain = ctx.chain
        chain_params = list(chain.parameters())
        with torch.enable_grad():
            x_ = x2.detach().requires_grad_(True)
            t_ = th2.detach().requires_grad_(True)
            out = fold_layers(chain, x_, t_, ctx.dirn, ctx.with_ldj)
            outs = list(out) if ctx.with_ldj else [out]
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x_, t_] + [p for p in chain_params if p.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True)
        it = iter(got[2:])
        g_params = [next(it) if p.requires_grad else None
                    for p in chain_params]
        g_x = got[0] if ctx.needs_input_grad[4] else None
        g_t = got[1] if ctx.needs_input_grad[5] else None
        return (None, None, None, None, g_x, g_t, *g_params)


def _chain_fused(chain, x2, th2, dirn, with_ldj, cached):
    if torch.is_grad_enabled():
        return _ChainFused.apply(chain, dirn, with_ldj, cached, x2, th2,
                                 *chain.parameters())
    plan, params, packed = cached
    return run_chain(plan, params, x2, th2, with_ldj=with_ldj, packed=packed)


def fused_plan(chain, d, n, dirn, device=None):
    """The routing decision and the plan lookup: ``(plan, params, packed),
    hit`` for the chain's current weights (``_cached_plan``) where the
    routing policy and the chain send rows of width ``d`` with ``n``
    conditions on ``device`` (default: the chain's) through the kernels in
    direction ``dirn``; None to keep the per-layer path."""
    device = _chain_device(chain) if device is None else device
    if not use_fused_chain(device) or not chain_is_fusable(chain, d, n):
        return None
    _require_kernel_limits(chain, d, n, device)
    return _cached_plan(chain, dirn, d, n)


def sample_fused(cached, generator, rows, d, theta_n, *, return_noise=False,
                 row_offset=0, total_rows=None):
    """One output-only kernel: in-kernel N(0, I) draw + the full forward
    sweep of ``cached``, the plan of :func:`fused_plan` for "fwd". ``theta_n``
    may be (1, n) — one θ broadcast to every draw without being
    materialised as (rows, n). Returns (rows, d). ``row_offset`` /
    ``total_rows``: rows ``[row_offset, row_offset + rows)`` of the draw of
    ``total_rows`` (``ops.chain_kernels.run_chain_sample``).

    On CUDA the draws are deterministic in the generator's state but are a
    different stream from ``torch.randn``.
    """
    plan, params, packed = cached
    if theta_n is not None and theta_n.shape[-1]:
        theta_n = theta_n.contiguous()
    return run_chain_sample(plan, params, rows, d, theta_n,
                            generator=generator, packed=packed,
                            return_noise=return_noise, row_offset=row_offset,
                            total_rows=total_rows)


def maybe_sample_fused(chain, generator, rows, d, theta_n, *,
                       return_noise=False, row_offset=0, total_rows=None):
    """:func:`sample_fused` where the routing policy and the chain allow
    it; None to keep the per-layer path."""
    n = theta_n.shape[-1] if theta_n is not None else 0
    found = fused_plan(chain, d, n, "fwd")
    if found is None:
        return None
    return sample_fused(found[0], generator, rows, d, theta_n,
                        return_noise=return_noise, row_offset=row_offset,
                        total_rows=total_rows)


def apply_fused(chain, y, theta, dirn, with_ldj, cached):
    """The whole chain as one kernel launch on ``y`` (batch..., d) with
    ``cached``, the plan of :func:`fused_plan`; ``(y, ldj)`` or ``y``
    alone."""
    batch_shape = y.shape[:-1]
    rows = int(np.prod(batch_shape))
    d = y.shape[-1]
    n = theta.shape[-1] if theta is not None else 0
    x2 = y.reshape(rows, d).contiguous()
    th2 = (theta.reshape(rows, n).contiguous() if theta is not None
           else y.new_zeros(rows, 0))
    out = _chain_fused(chain, x2, th2, dirn, with_ldj, cached)
    if with_ldj:
        yy, ldj = out
        return yy.reshape(y.shape), ldj.reshape(batch_shape)
    return out.reshape(y.shape)


def maybe_apply_fused(chain, y, theta, dirn, with_ldj):
    """Run the whole chain as one fused kernel where the routing policy and
    the chain allow it; returns None to keep the per-layer path.
    ``dirn``: "fwd" | "inv"."""
    if y.dim() < 2:
        return None
    n = theta.shape[-1] if theta is not None else 0
    found = fused_plan(chain, y.shape[-1], n, dirn, y.device)
    if found is None:
        return None
    return apply_fused(chain, y, theta, dirn, with_ldj, found[0])
