"""The folded layout of a coupling's conditioners, which the chain kernels
(``fused_chain.py``) and the training kernels (``fused_train.py``) both read.

The fold does the coupling's static split and recombine in the weights, so
a kernel does no selection work:

- the first dense layer (K, H), K = n + |id|, splits into its θ block (n, H)
  and its x block zero-padded to (d, H) at the identity dims, so that
  ``θ@W1θ + x@W1x`` is ``[θ | x[:, id]] @ W1``;
- the hidden layers stay as they are;
- the last layer (H, A) and its bias scatter to d columns at the transformed
  dims, so the net emits d-wide s / t that are 0 on the identity dims and
  ``y = x·exp(s) + t`` is the whole coupling. A joint net's last layer
  (H, 2A) folds as two such heads, s then t.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
)

__all__ = ["conditioner_nets", "axes_idx", "fold_coupling",
           "normalization_affine"]


def conditioner_nets(layer) -> tuple:
    """The coupling's conditioner MLPs in fold order; () for other layers."""
    if isinstance(layer, JointRNVPCouplingLayer):
        return (layer.st_net,)
    if isinstance(layer, RNVPCouplingLayer):
        return (layer.s_net, layer.t_net)
    if isinstance(layer, NICECouplingLayer):
        return (layer.t_net,)
    return ()


def axes_idx(layer, coord_map=None):
    """The coupling's identity and transformed dims as int64 arrays, relabeled
    through ``coord_map`` (kernel-frame dim per layer-frame dim) if given."""
    ax = layer.axes
    id_idx = np.asarray(ax.axis_id, np.int64)
    af_idx = np.asarray(ax.axis_af, np.int64)
    if coord_map is not None:
        id_idx, af_idx = coord_map[id_idx], coord_map[af_idx]
    return id_idx, af_idx


def _scatter_rows(w, d, idx):
    out = w.new_zeros(d, w.shape[1])
    out[idx] = w
    return out


def _scatter_cols(w, d, idx):
    out = w.new_zeros(w.shape[0], d)
    out[:, idx] = w
    return out


def _heads(t, heads):
    """``t``'s columns as ``heads`` equal heads (no view op for one)."""
    return t.chunk(heads, 1) if heads > 1 else (t,)


def _fold_net(net, get, d, n, id_idx, af_idx, heads):
    """One conditioner MLP folded, its last layer and bias as ``heads``
    heads; beside each tensor the 0/1 mask of its scattered entries, or None
    where nothing was scattered."""
    ws = [get(w) for w in net.weights]
    params, masks = [], []

    def scatter(t, how, idx):
        params.append(how(t, d, idx))
        masks.append(how(torch.ones_like(t), d, idx))

    if n > 0:
        params.append(ws[0][:n])
        masks.append(None)
    if len(id_idx) > 0:
        scatter(ws[0][n:], _scatter_rows, id_idx)
    params.extend(ws[1:-1])
    masks.extend([None] * (len(ws) - 2))
    for head in _heads(ws[-1], heads):
        scatter(head, _scatter_cols, af_idx)
    if net.has_bias:
        bs = [get(b).reshape(1, -1) for b in net.biases]
        params.extend(bs[:-1])
        masks.extend([None] * (len(bs) - 1))
        for head in _heads(bs[-1], heads):
            scatter(head, _scatter_cols, af_idx)
    return params, masks


def fold_coupling(layer, get, dirn, coord_map=None):
    """``(op, params, masks)`` of an RNVP, joint or NICE coupling.

    ``op`` is the kernels' descriptor for direction ``dirn``, ``("coupling",
    kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th, has_id,
    clamp)``; ``params`` the folded tensors, each of the layer's tensors
    first passed through ``get``; ``masks`` the 0/1 mask of each folded
    tensor's scattered entries, or None. ``coord_map`` relabels the layer's
    axes into the kernel's frame (how the training plan folds permutations
    away). The caller has checked that the layer is within its kernels'
    envelope: axes that are not degenerate, nets of two dense layers or
    more."""
    ax = layer.axes
    id_idx, af_idx = axes_idx(layer, coord_map)
    nets = conditioner_nets(layer)
    heads = 2 if isinstance(layer, JointRNVPCouplingLayer) else 1
    params, masks = [], []
    for net in nets:
        p, m = _fold_net(net, get, ax.d, ax.n, id_idx, af_idx, heads)
        params += p
        masks += m
    shapes = [(len(net.weights), net.activation, net.has_bias) for net in nets]
    if isinstance(layer, JointRNVPCouplingLayer):
        kind, s, t = "joint", shapes[0], (0, nets[0].activation, False)
    elif isinstance(layer, RNVPCouplingLayer):
        kind, (s, t) = "nvp", shapes
    else:
        kind, s, t = "nice", (0, "identity", False), shapes[0]
    op = ("coupling", kind, dirn, s[0], t[0], s[1], t[1], s[2], t[2],
          ax.n > 0, len(ax.axis_id) > 0,
          float(getattr(layer, "max_log_scale", 0.0)))
    return op, params, masks


def normalization_affine(layer, dirn):
    """A NormalizationLayer as the constants ``[a (1, d), b (1, d), ldj
    (1, 1)]`` of ``y = a·x + b``: "fwd" maps [α, β] to the data range, "inv"
    the data range to [α, β]."""
    lo, hi = layer.x_min.detach(), layer.x_max.detach()
    diff = hi - lo
    delta = layer.beta - layer.alpha
    c = torch.log(diff / delta).sum().reshape(1, 1)
    if dirn == "fwd":
        a = diff / delta
        b = (layer.beta * lo - layer.alpha * hi) / delta
        return [a.reshape(1, -1), b.reshape(1, -1), c]
    a = delta / diff
    b = (layer.alpha * hi - layer.beta * lo) / diff
    return [a.reshape(1, -1), b.reshape(1, -1), -c]
