"""Checkpointing: declarative spec + arrays save/load for flows.

PyTorch counterpart of ``densityflows_tpu/utils/checkpoint.py``. It reads
and writes the JAX package's on-disk format, so a flow saved by either
package loads in the other: per element a ``spec.json`` (architecture, axes,
activation names, static config) plus one ``arrays.npz`` of parameter arrays
named ``leaf_%05d`` in the JAX package's pytree-flatten order; per flow a
``flow.json`` (metadata + loss histories) beside ``model/`` and ``base/``.

The leaf order of an element is the field order of the JAX dataclass:
``MLP``: all weights, then all biases; ``RNVPCouplingLayer``: ``s_net``,
``t_net``; ``JointRNVPCouplingLayer``: ``st_net``; ``NICECouplingLayer``:
``t_net``; ``NormalizationLayer``: ``x_min``, ``x_max``; ``ActNormLayer``:
``bias``, ``log_scale``; ``InvertibleLinearLayer``: ``lower``, ``upper``,
``log_s``; ``LogitLayer``: ``lo``, ``hi``; ``RQSCouplingLayer``: ``p_net``;
``MaskedMLP``: all weights, then all biases (the masks are rebuilt from the
``"made"`` descriptor, or from a legacy ``"masks"`` spec, and hold no leaf);
``MAFLayer`` / ``IAFLayer``: ``net``; ``EmbeddedChain``: ``embed``, then
``chain``; ``DiagNormal``: ``mean``, ``scale``; ``GaussianMixture``:
``means``, ``scales``, ``logits``; ``BoxUniform``: ``lo``, ``hi``;
``PermutationLayer`` and ``StandardNormal``: none; containers: their
children in order.

Elements with no counterpart in that format — ``LULinearLayer``, a
``ResidualNet`` conditioner and its batch norms, a spline coupling in
nflows' direction or with divided bin widths — have a leaf order (their
parameters make up ``trainable_leaves``) but no spec: saving a flow that
holds one raises ``NotImplementedError`` before anything is written.

Dtypes: float32, and bfloat16 for the conditioners that
``models.layers.cast_conditioners`` casts. A bfloat16 leaf is stored as its
2-byte raw values (``|V2`` in the npz, the bytes the JAX package writes) and
read back through the dtype its element's spec names.

Ensembles: ``save_ensemble`` writes ``ensemble.json`` (the member spec, the
base spec, metadata and the ``(epochs, K)`` histories), ``stacked.npz``
(every member leaf with a leading K axis, the JAX package's stacked pytree)
and ``base.npz``.

Optimizer state: ``save_flow(dir, flow, opt_state)`` writes ``opt_state.npz``
in the leaf order of the JAX package's ``optax.adam`` state — the int32
count, then one first-moment array per model leaf, then one second-moment
array per model leaf — so a run saved by either package resumes in the other.
Leaves that are buffers here (``NormalizationLayer.x_min`` / ``x_max``,
``LogitLayer.lo`` / ``hi``) carry zero moments in that file and none in this
package's :class:`~densityflows_tpu_torch.train.AdamState`.

Tensor parallelism: ``save_flow`` of a chain placed by
``parallel.mesh.shard_params_tp`` joins every ``TensorParallelMLP``'s shards
(and the Adam moments' shards) over the mesh's ``model`` axis, so the files
hold the same bytes as the replicated chain's. Every rank of the axis calls
it; its rank 0 writes. A ``TensorParallelMLP``'s spec is the one of the MLP
it places. ``utils.orbax_ckpt`` saves such a chain without the gather (each
rank writes its shards) beside the same specs.
"""

from __future__ import annotations

import copy
import json
import os
import shutil

import numpy as np
import torch

from .._device import resolve_device
from ..axes import CouplingAxes
from ..data import MetaData
from ..models.blocks import CouplingBlock
from ..models.autoregressive import IAFLayer, MAFLayer
from ..models.chains import FlowChain
from ..models.distributions import (
    BoxUniform, DiagNormal, GaussianMixture, StandardNormal,
)
from ..models.embedding import EmbeddedChain
from ..models.flow import Flow
from ..models.glow import ActNormLayer, InvertibleLinearLayer, LULinearLayer
from ..models.layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
    RQSCouplingLayer,
)
from ..models.normalization import (
    LogitLayer, NormalizationLayer, PermutationLayer,
)
from ..ops.made import MaskedMLP, made_masks
from ..ops.mlp import (
    MLP, BatchNorm, ResidualBlock, ResidualNet, TensorParallelMLP,
)

__all__ = [
    "save_flow", "load_flow", "save_ensemble", "load_ensemble",
    "save_element", "load_element",
    "element_spec", "element_from_spec", "element_leaves",
    "set_element_leaves", "register_element",
    "adam_state_to_leaves", "adam_state_from_leaves",
]

_FORMAT_VERSION = 1

_TO_SPEC: dict[type, tuple] = {}
_FROM_SPEC: dict[str, object] = {}


def _default_children(el):
    if isinstance(el, torch.nn.Module):
        return list(el.parameters()) + list(el.buffers())
    return []


def register_element(cls, to_spec, from_spec, *, name: str | None = None,
                     children=None):
    """Register a flow element type for checkpointing.

    - ``to_spec(el) -> dict``: JSON-able structural description (no arrays);
    - ``from_spec(spec, device) -> element``: rebuild a skeleton whose array
      values are overwritten afterwards;
    - ``children(el) -> list``: the element's tensors and sub-elements in
      leaf order (default: an ``nn.Module``'s parameters, then buffers).

    ``name`` defaults to ``cls.__name__`` and is the ``"type"`` tag.
    """
    name = name or cls.__name__
    _TO_SPEC[cls] = (name, to_spec, children or _default_children)
    _FROM_SPEC[name] = from_spec


def _entry(el):
    entry = _TO_SPEC.get(type(el))
    if entry is None:
        raise TypeError(
            f"don't know how to checkpoint {type(el).__name__}; register it "
            "with register_element(cls, to_spec, from_spec)")
    return entry


def element_spec(el) -> dict:
    """JSON-able structural description of a flow element (exact type
    only)."""
    name, fn, _ = _entry(el)
    spec = dict(fn(el))
    spec["type"] = name
    return spec


def element_from_spec(spec: dict, device=None):
    """Rebuild a flow element skeleton (placeholder arrays) from its spec."""
    device = resolve_device(device)
    t = spec["type"]
    fn = _FROM_SPEC.get(t)
    if fn is None:
        raise ValueError(
            f"unknown element type in checkpoint: {t} (custom layers must "
            "be register_element'd before loading)")
    return fn(spec, device)


def element_leaves(el) -> list[torch.Tensor]:
    """The element's arrays in the JAX package's pytree-flatten order."""
    out = []
    for child in _entry(el)[2](el):
        if isinstance(child, torch.Tensor):
            out.append(child)
        else:
            out.extend(element_leaves(child))
    return out


def set_element_leaves(el, arrays) -> None:
    """Overwrite the element's arrays, in leaf order, with ``arrays``
    (numpy arrays or tensors of matching shapes)."""
    leaves = element_leaves(el)
    arrays = list(arrays)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"element has {len(leaves)} leaves, got {len(arrays)} arrays")
    with torch.no_grad():
        for leaf, a in zip(leaves, arrays):
            if not isinstance(a, torch.Tensor):
                a = _array_tensor(a)
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} != array shape "
                    f"{tuple(a.shape)}")
            if a.dtype not in _DTYPES.values():
                raise TypeError(
                    f"checkpoint arrays must be float32 or bfloat16, got "
                    f"{a.dtype}")
            if a.dtype != leaf.dtype:
                raise TypeError(
                    f"a {a.dtype} array for a {leaf.dtype} leaf: the spec "
                    "names the leaf's dtype")
            leaf.copy_(a)


def _array_tensor(a) -> torch.Tensor:
    """A writable tensor copy of a numpy array. A bfloat16 leaf comes as
    2-byte raw values (``|V2``: what ``np.load`` gives for a bfloat16 array
    written by the JAX package) or as an ``ml_dtypes`` bfloat16 array; both
    carry the bfloat16 bits, which are taken as they are."""
    a = np.asarray(a)
    if (a.dtype.kind == "V" and a.dtype.itemsize == 2) \
            or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.as_tensor(np.array(a))


def _leaf_key(i: int) -> str:
    """The name of leaf ``i`` (leaf order) in every array store: the npz
    files and the sharded format of ``utils.orbax_ckpt``."""
    return f"leaf_{i:05d}"


def _leaf_array(t: torch.Tensor) -> np.ndarray:
    """A leaf as the numpy array the JAX package writes: float32 as it is,
    bfloat16 as its 2-byte raw values (``|V2``), the bytes JAX stores."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


# -- built-in registrations ---------------------------------------------------

def _axes_spec(axes: CouplingAxes) -> dict:
    return {"d": axes.d, "n": axes.n, "axis_id": list(axes.axis_id),
            "axis_af": list(axes.axis_af), "axis_nn": list(axes.axis_nn)}


def _axes_from_spec(s: dict) -> CouplingAxes:
    return CouplingAxes(s["d"], s["n"], tuple(s["axis_id"]),
                        tuple(s["axis_af"]), tuple(s["axis_nn"]))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _zeros(shape, device, dtype=torch.float32):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _spec_dtype(s) -> torch.dtype:
    """The element's array dtype as its spec names it: float32, or bfloat16
    (conditioners stored by ``cast_conditioners``)."""
    name = s.get("dtype", "float32")
    if name not in _DTYPES:
        raise NotImplementedError(
            f"checkpoint dtype {name} is not supported (float32 or "
            "bfloat16)")
    return _DTYPES[name]


def _mlp_from_spec(s, device):
    dt = _spec_dtype(s)
    return MLP([_zeros(sh, device, dt) for sh in s["weight_shapes"]],
               [_zeros(sh, device, dt) for sh in s["bias_shapes"]],
               s["activation"])


register_element(
    MLP,
    lambda el: {
        "weight_shapes": [list(w.shape) for w in el.weights],
        "bias_shapes": [list(b.shape) for b in el.biases],
        "dtype": _dtype_name(el.weights[0]) if len(el.weights) else "float32",
        "activation": el.activation,
    },
    _mlp_from_spec,
    children=lambda el: list(el.weights) + list(el.biases),
)

def _tp_full_shape(t, spec, model_size) -> list:
    shape = list(t.shape)
    if "model" in spec:
        shape[spec.index("model")] *= model_size
    return shape


# a TensorParallelMLP's spec is the one of the MLP it places (the shapes
# joined over the ``model`` axis), so it loads as that MLP
register_element(
    TensorParallelMLP,
    lambda el: {
        "weight_shapes": [_tp_full_shape(w, s, el.mesh.model_size)
                          for w, s in zip(el.weights, el.weight_specs)],
        "bias_shapes": [_tp_full_shape(b, s, el.mesh.model_size)
                        for b, s in zip(el.biases, el.bias_specs)],
        "dtype": _dtype_name(el.weights[0]),
        "activation": el.activation,
    },
    _mlp_from_spec,
    name="MLP",
    children=lambda el: list(el.weights) + list(el.biases),
)

register_element(
    RNVPCouplingLayer,
    lambda el: {
        "s_net": element_spec(el.s_net),
        "t_net": element_spec(el.t_net),
        "axes": _axes_spec(el.axes),
        "max_log_scale": float(el.max_log_scale),
    },
    lambda s, dev: RNVPCouplingLayer(
        element_from_spec(s["s_net"], dev),
        element_from_spec(s["t_net"], dev),
        _axes_from_spec(s["axes"]),
        float(s.get("max_log_scale", 0.0)),
    ),
    children=lambda el: [el.s_net, el.t_net],
)

register_element(
    JointRNVPCouplingLayer,
    lambda el: {
        "st_net": element_spec(el.st_net),
        "axes": _axes_spec(el.axes),
        "max_log_scale": float(el.max_log_scale),
    },
    lambda s, dev: JointRNVPCouplingLayer(
        element_from_spec(s["st_net"], dev),
        _axes_from_spec(s["axes"]),
        float(s.get("max_log_scale", 0.0)),
    ),
    children=lambda el: [el.st_net],
)

register_element(
    NICECouplingLayer,
    lambda el: {"t_net": element_spec(el.t_net), "axes": _axes_spec(el.axes)},
    lambda s, dev: NICECouplingLayer(
        element_from_spec(s["t_net"], dev), _axes_from_spec(s["axes"])),
    children=lambda el: [el.t_net],
)


def _no_spec(what):
    raise NotImplementedError(
        f"{what} has no counterpart in the JAX package's checkpoint format; "
        "save_flow / save_element cannot write a flow that holds it")


def _rqs_spec(el):
    if el.spline_on != "sample" or el.bin_divisor != 1.0:
        _no_spec("a spline coupling with spline_on='density' or a "
                 "bin_divisor")
    return {"p_net": element_spec(el.p_net), "axes": _axes_spec(el.axes),
            "n_bins": int(el.n_bins), "bound": float(el.bound)}


for _cls, _children in (
        (LULinearLayer, lambda el: [el.lower, el.upper,
                                    el.unconstrained_diag, el.bias]),
        (BatchNorm, lambda el: [el.weight, el.bias, el.running_mean,
                                el.running_var]),
        (ResidualBlock, lambda el: list(el.norms) + [
            el.w0, el.b0, el.w1, el.b1]
            + ([el.wc, el.bc] if el.wc is not None else [])),
        (ResidualNet, lambda el: [el.w_in, el.b_in] + list(el.blocks)
            + [el.w_out, el.b_out])):
    register_element(_cls, lambda el: _no_spec(type(el).__name__),
                     lambda s, dev: _no_spec(s["type"]), children=_children)


register_element(
    RQSCouplingLayer,
    _rqs_spec,
    lambda s, dev: RQSCouplingLayer(
        element_from_spec(s["p_net"], dev), _axes_from_spec(s["axes"]),
        s["n_bins"], s["bound"]),
    children=lambda el: [el.p_net],
)


def _made_descriptor_from_spec(s: dict) -> tuple:
    """Descriptor of a MaskedMLP spec. Current specs store it (``"made"``);
    legacy specs stored the full mask grids (``"masks"``): for those, infer
    (d, n_cond, P) from the layer shapes by search and check that the
    rebuilt masks equal the stored ones exactly."""
    if "made" in s:
        m = s["made"]
        return (int(m[0]), int(m[1]), int(m[2]), tuple(int(h) for h in m[3]))
    in_dim = s["weight_shapes"][0][0]
    out_dim = s["weight_shapes"][-1][1]
    hidden = tuple(int(sh[1]) for sh in s["weight_shapes"][:-1])
    stored = [np.asarray(m, np.float32) for m in s["masks"]]
    for p in range(1, out_dim + 1):
        if out_dim % p:
            continue
        d = out_dim // p
        n_cond = in_dim - d
        if n_cond < 0:
            continue
        rebuilt = made_masks(d, n_cond, p, hidden)
        if len(rebuilt) == len(stored) and all(
                a.shape == b.shape and np.array_equal(a, b)
                for a, b in zip(rebuilt, stored)):
            return (d, n_cond, p, hidden)
    raise ValueError(
        "legacy MaskedMLP checkpoint masks don't match any MADE descriptor")


def _made_from_spec(s, device):
    dt = _spec_dtype(s)
    return MaskedMLP([_zeros(sh, device, dt) for sh in s["weight_shapes"]],
                     [_zeros(sh, device, dt) for sh in s["bias_shapes"]],
                     _made_descriptor_from_spec(s), s["activation"])


register_element(
    MaskedMLP,
    lambda el: {
        "weight_shapes": [list(w.shape) for w in el.weights],
        "bias_shapes": [list(b.shape) for b in el.biases],
        "made": [el.made[0], el.made[1], el.made[2], list(el.made[3])],
        "dtype": _dtype_name(el.weights[0]),
        "activation": el.activation,
    },
    _made_from_spec,
    children=lambda el: list(el.weights) + list(el.biases),
)


def _ar_spec(el):
    return {"net": element_spec(el.net), "d": int(el.d), "n": int(el.n),
            "max_log_scale": float(el.max_log_scale)}


def _ar_from_spec(cls):
    return lambda s, dev: cls(element_from_spec(s["net"], dev), s["d"],
                              s["n"], s["max_log_scale"])


register_element(MAFLayer, _ar_spec, _ar_from_spec(MAFLayer),
                 children=lambda el: [el.net])
register_element(IAFLayer, _ar_spec, _ar_from_spec(IAFLayer),
                 children=lambda el: [el.net])

register_element(
    EmbeddedChain,
    lambda el: {"embed": element_spec(el.embed),
                "chain": element_spec(el.chain)},
    lambda s, dev: EmbeddedChain(element_from_spec(s["embed"], dev),
                                 element_from_spec(s["chain"], dev)),
    children=lambda el: [el.embed, el.chain],
)


def _norm_from_spec(s, device):
    z = _zeros((s["d"],), device, _spec_dtype(s))
    # skeleton x_max=1 keeps the placeholder valid (x_max > x_min)
    return NormalizationLayer(z, z + 1, s["alpha"], s["beta"])


register_element(
    NormalizationLayer,
    lambda el: {
        "d": int(el.x_min.shape[0]),
        "dtype": _dtype_name(el.x_min),
        "alpha": float(el.alpha),
        "beta": float(el.beta),
    },
    _norm_from_spec,
    children=lambda el: [el.x_min, el.x_max],
)

register_element(
    PermutationLayer,
    lambda el: {"perm": list(el.perm)},
    lambda s, dev: PermutationLayer(tuple(s["perm"])),
    children=lambda el: [],
)


def _actnorm_from_spec(s, device):
    dt = _spec_dtype(s)
    return ActNormLayer(_zeros((s["d"],), device, dt),
                        _zeros((s["d"],), device, dt))


register_element(
    ActNormLayer,
    lambda el: {"d": int(el.bias.shape[0]), "dtype": _dtype_name(el.bias)},
    _actnorm_from_spec,
    children=lambda el: [el.bias, el.log_scale],
)


def _invlinear_from_spec(s, device):
    dt, d = _spec_dtype(s), s["d"]
    return InvertibleLinearLayer(
        _zeros((d, d), device, dt), _zeros((d, d), device, dt),
        _zeros((d,), device, dt),
        tuple(s["perm"]), tuple(s["sign"]))


register_element(
    InvertibleLinearLayer,
    lambda el: {
        "d": el.d,
        "dtype": _dtype_name(el.log_s),
        "perm": list(el.perm),
        "sign": [float(v) for v in el.sign],
    },
    _invlinear_from_spec,
    children=lambda el: [el.lower, el.upper, el.log_s],
)

register_element(
    CouplingBlock,
    lambda el: {"layer_1": element_spec(el.layer_1),
                "layer_2": element_spec(el.layer_2)},
    lambda s, dev: CouplingBlock(element_from_spec(s["layer_1"], dev),
                                 element_from_spec(s["layer_2"], dev)),
    children=lambda el: [el.layer_1, el.layer_2],
)

register_element(
    FlowChain,
    lambda el: {"layers": [element_spec(l) for l in el.layers]},
    lambda s, dev: FlowChain(
        [element_from_spec(v, dev) for v in s["layers"]]),
    children=lambda el: list(el.layers),
)


def _logit_from_spec(s, device):
    z = _zeros((s["d"],), device, _spec_dtype(s))
    return LogitLayer(z, z + 1, s["eps"])


register_element(
    LogitLayer,
    lambda el: {"d": int(el.lo.shape[0]), "dtype": _dtype_name(el.lo),
                "eps": float(el.eps)},
    _logit_from_spec,
    children=lambda el: [el.lo, el.hi],
)

register_element(
    StandardNormal,
    lambda el: {"d": el.d},
    lambda s, dev: StandardNormal(s["d"]),
    children=lambda el: [],
)


def _diag_from_spec(s, device):
    dt = _spec_dtype(s)
    return DiagNormal(_zeros((s["d"],), device, dt),
                      _zeros((s["d"],), device, dt) + 1)


register_element(
    DiagNormal,
    lambda el: {"d": el.d, "dtype": _dtype_name(el.mean)},
    _diag_from_spec,
    children=lambda el: [el.mean, el.scale],
)


def _mixture_from_spec(s, device):
    dt, k, d = _spec_dtype(s), s["k"], s["d"]
    return GaussianMixture(_zeros((k, d), device, dt),
                           _zeros((k, d), device, dt) + 1,
                           _zeros((k,), device, dt))


register_element(
    GaussianMixture,
    lambda el: {"k": el.k, "d": el.d, "dtype": _dtype_name(el.means)},
    _mixture_from_spec,
    children=lambda el: [el.means, el.scales, el.logits],
)


def _box_from_spec(s, device):
    z = _zeros((s["d"],), device, _spec_dtype(s))
    return BoxUniform(z, z + 1)


register_element(
    BoxUniform,
    lambda el: {"d": el.d, "dtype": _dtype_name(el.lo)},
    _box_from_spec,
    children=lambda el: [el.lo, el.hi],
)


# -- element-level API ------------------------------------------------------------

def _prepare_dir(directory: str, erase: bool) -> None:
    if os.path.exists(directory):
        if erase:
            shutil.rmtree(directory)
        elif os.listdir(directory):
            raise FileExistsError(
                f"{directory} exists and is not empty (pass erase=True)"
            )
    os.makedirs(directory, exist_ok=True)


def save_element(directory: str, el, *, erase: bool = False) -> None:
    """Persist one flow element."""
    if _tp_nets(el):
        raise TypeError(
            "a TensorParallelMLP holds one rank's shards: save the flow with "
            "save_flow, which joins them over the mesh's 'model' axis, or "
            "with utils.orbax_ckpt.save_flow_orbax, which writes each rank's "
            "shards")
    spec = element_spec(el)
    _prepare_dir(directory, erase)
    with open(os.path.join(directory, "spec.json"), "w") as f:
        json.dump({"format_version": _FORMAT_VERSION, "spec": spec}, f,
                  indent=1)
    arrays = {_leaf_key(i): _leaf_array(leaf)
              for i, leaf in enumerate(element_leaves(el))}
    np.savez(os.path.join(directory, "arrays.npz"), **arrays)


def load_element(directory: str, *, device=None):
    """Load one flow element onto ``device``."""
    device = resolve_device(device)
    with open(os.path.join(directory, "spec.json")) as f:
        payload = json.load(f)
    el = element_from_spec(payload["spec"], device)
    with np.load(os.path.join(directory, "arrays.npz")) as npz:
        n = len(element_leaves(el))
        set_element_leaves(el, [npz[_leaf_key(i)] for i in range(n)])
    return el


# -- optimizer state ------------------------------------------------------------

def _is_trainable(t) -> bool:
    return isinstance(t, torch.nn.Parameter)


def _is_adam_state(opt_state) -> bool:
    return all(hasattr(opt_state, f) for f in ("count", "mu", "nu"))


def _adam_moments(model, opt_state) -> tuple[list, list]:
    """The first and the second moments of an Adam state, one per leaf of
    ``model`` in leaf order: the state's for a trainable leaf, zeros for a
    leaf this package holds as a buffer (the layout of ``optax.adam``'s
    state)."""
    leaves = element_leaves(model)
    n_train = sum(_is_trainable(t) for t in leaves)
    if not _is_adam_state(opt_state):
        raise TypeError(
            "only an Adam state (count, mu, nu) can be written to a "
            f"checkpoint, got {type(opt_state).__name__}")
    if len(opt_state.mu) != n_train or len(opt_state.nu) != n_train:
        raise ValueError(
            f"the model has {n_train} trainable leaves, the optimizer state "
            f"{len(opt_state.mu)} / {len(opt_state.nu)} moments")
    out = []
    for moments in (opt_state.mu, opt_state.nu):
        it = iter(moments)
        per_leaf = []
        for t in leaves:
            m = next(it) if _is_trainable(t) else torch.zeros_like(t)
            if tuple(m.shape) != tuple(t.shape):
                raise ValueError(
                    f"moment shape {tuple(m.shape)} != leaf shape "
                    f"{tuple(t.shape)}")
            per_leaf.append(m.detach())
        out.append(per_leaf)
    return out[0], out[1]


def adam_state_to_leaves(model, opt_state) -> list[np.ndarray]:
    """An :class:`~densityflows_tpu_torch.train.AdamState` as numpy arrays in
    the leaf order of the JAX package's ``optax.adam`` state for the same
    model: count, a first moment per model leaf, a second moment per model
    leaf (zeros for the leaves this package holds as buffers)."""
    mu, nu = _adam_moments(model, opt_state)
    return [np.asarray(int(opt_state.count), np.int32)] + [
        m.cpu().numpy() for m in mu + nu]


def adam_state_from_leaves(model, arrays):
    """The inverse of :func:`adam_state_to_leaves`: build the state for
    ``model`` (moments on the model's device) from the arrays of an
    ``optax.adam`` state in ``jax.tree_util.tree_leaves`` order, which is the
    order of ``opt_state.npz``."""
    from ..train import AdamState

    leaves = element_leaves(model)
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != 1 + 2 * len(leaves):
        raise ValueError(
            f"an Adam state of this model has {1 + 2 * len(leaves)} leaves "
            f"(count, mu, nu), got {len(arrays)}: only Adam-family optimizer "
            "state can be carried across")
    if arrays[0].shape != () or not np.issubdtype(arrays[0].dtype,
                                                  np.integer):
        raise ValueError("the first leaf of an Adam state is its int count")
    moments = []
    for part in (arrays[1:1 + len(leaves)], arrays[1 + len(leaves):]):
        vals = []
        for t, a in zip(leaves, part):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(
                    f"moment shape {tuple(a.shape)} != leaf shape "
                    f"{tuple(t.shape)}")
            if _is_trainable(t):
                vals.append(torch.as_tensor(np.array(a, np.float32))
                            .to(t.device))
        moments.append(vals)
    return AdamState(int(arrays[0]), moments[0], moments[1])


# -- tensor-parallel chains -----------------------------------------------------------

def _tp_nets(model) -> list:
    return [m for m in model.modules() if isinstance(m, TensorParallelMLP)] \
        if isinstance(model, torch.nn.Module) else []


def _leaf_shard_dims(el) -> list:
    """Per leaf of ``el`` (leaf order), ``(mesh, dim)`` for a leaf split over
    a ``model`` axis, else None."""
    if isinstance(el, TensorParallelMLP):
        return [None if d is None else (el.mesh, d) for d in el.shard_dims()]
    out = []
    for child in _entry(el)[2](el):
        out.extend([None] if isinstance(child, torch.Tensor)
                   else _leaf_shard_dims(child))
    return out


def _gather_tp(model, opt_state):
    """The replicated model and Adam state of a tensor-parallel one: every
    ``TensorParallelMLP`` gathered into its ``MLP`` (a collective over the
    ``model`` axis, in module order on every rank)."""
    out = copy.deepcopy(model)

    def swap(module):
        for name, child in list(module.named_children()):
            if isinstance(child, TensorParallelMLP):
                setattr(module, name, child.gather())
            else:
                swap(child)

    dims = [dm for t, dm in zip(element_leaves(model),
                                _leaf_shard_dims(model)) if _is_trainable(t)]
    swap(out)
    if opt_state is not None and _is_adam_state(opt_state):
        def join(moments):
            return [m if dm is None else dm[0].all_gather_model(m, dm[1])
                    for m, dm in zip(moments, dims)]

        opt_state = type(opt_state)(opt_state.count, join(opt_state.mu),
                                    join(opt_state.nu))
    return out, opt_state


# -- flow-level API -------------------------------------------------------------------

def save_flow(directory: str, flow: Flow, opt_state=None, *,
              erase: bool = False) -> None:
    """Persist a complete flow: model + base + metadata + loss histories
    (+ optionally the Adam state ``train`` returned).

    A tensor-parallel chain (``parallel.mesh.shard_params_tp``) is saved as
    the replicated chain: every rank of its ``model`` axis calls this, the
    shards are gathered, and the axis's rank 0 writes."""
    model = flow.model
    nets = _tp_nets(model)
    if nets:
        model, opt_state = _gather_tp(model, opt_state)
        if nets[0].mesh.model_rank != 0:
            return
    element_spec(model)   # raises for an element the format cannot hold
    _prepare_dir(directory, erase)
    save_element(os.path.join(directory, "model"), model, erase=erase)
    save_element(os.path.join(directory, "base"), flow.base, erase=erase)
    with open(os.path.join(directory, "flow.json"), "w") as f:
        json.dump({"format_version": _FORMAT_VERSION,
                   **_flow_record(flow, opt_state)}, f, indent=1)
    if opt_state is not None:
        arrays = adam_state_to_leaves(model, opt_state)
        np.savez(os.path.join(directory, "opt_state.npz"),
                 **{_leaf_key(i): a for i, a in enumerate(arrays)})


def _metadata_dict(md) -> dict:
    return {"hash": md.hash, "d": md.d, "n": md.n,
            "theta_min": np.asarray(md.theta_min).tolist(),
            "theta_max": np.asarray(md.theta_max).tolist()}


def _flow_record(flow, opt_state) -> dict:
    """The keys of ``flow.json`` that every flow format writes: metadata,
    loss histories and whether optimizer state was saved."""
    return {"metadata": _metadata_dict(flow.metadata),
            "train_loss": [float(v) for v in flow.train_loss],
            "valid_loss": [float(v) for v in flow.valid_loss],
            "has_opt_state": opt_state is not None}


def _metadata_from(md) -> MetaData:
    return MetaData(md["hash"], md["d"], md["n"],
                    np.asarray(md["theta_min"], np.float32),
                    np.asarray(md["theta_max"], np.float32))


def _npz_leaves(path, n) -> list:
    with np.load(path) as npz:
        return [npz[_leaf_key(i)] for i in range(n)]


def save_ensemble(directory: str, ens, *, erase: bool = False) -> None:
    """Persist an :class:`~densityflows_tpu_torch.ensemble.EnsembleFlow` in
    the JAX package's ensemble format: the stacked member parameters (every
    leaf with a leading K axis) through the element spec/arrays format."""
    _prepare_dir(directory, erase)
    with open(os.path.join(directory, "ensemble.json"), "w") as f:
        json.dump({
            "format_version": _FORMAT_VERSION,
            "n_members": ens.n_members,
            "member_spec": element_spec(ens.model[0]),
            "base": element_spec(ens.base),
            "metadata": _metadata_dict(ens.metadata),
            "train_loss": [list(map(float, row)) for row in ens.train_loss],
            "valid_loss": [list(map(float, row)) for row in ens.valid_loss],
        }, f, indent=1)
    np.savez(os.path.join(directory, "stacked.npz"),
             **{_leaf_key(i): _leaf_array(leaf)
                for i, leaf in enumerate(ens.model.leaves())})
    np.savez(os.path.join(directory, "base.npz"),
             **{_leaf_key(i): _leaf_array(leaf)
                for i, leaf in enumerate(element_leaves(ens.base))})


def load_ensemble(directory: str, *, device=None):
    """Load an ensemble saved by :func:`save_ensemble` (of this package or of
    the JAX package) onto ``device``."""
    from ..ensemble import EnsembleFlow, StackedModels

    device = resolve_device(device)
    with open(os.path.join(directory, "ensemble.json")) as f:
        meta = json.load(f)
    k = int(meta["n_members"])
    members = [element_from_spec(meta["member_spec"], device)
               for _ in range(k)]
    stacked = _npz_leaves(os.path.join(directory, "stacked.npz"),
                          len(element_leaves(members[0])))
    for i, m in enumerate(members):
        set_element_leaves(m, [a[i] for a in stacked])
    base = element_from_spec(meta["base"], device)
    set_element_leaves(base, _npz_leaves(os.path.join(directory, "base.npz"),
                                         len(element_leaves(base))))
    return EnsembleFlow(StackedModels(members), _metadata_from(meta["metadata"]),
                        base, k, train_loss=meta["train_loss"],
                        valid_loss=meta["valid_loss"], device=device)


def load_flow(directory: str, optimizer=None, *, device=None):
    """Load a flow saved by :func:`save_flow` (of this package or of the JAX
    package) onto ``device``.

    If ``optimizer`` (an :class:`~densityflows_tpu_torch.train.Adam`) is
    given and the checkpoint holds optimizer state, returns ``(flow,
    opt_state)``; otherwise returns just the flow."""
    device = resolve_device(device)
    with open(os.path.join(directory, "flow.json")) as f:
        meta = json.load(f)
    model = load_element(os.path.join(directory, "model"), device=device)
    base = load_element(os.path.join(directory, "base"), device=device)
    flow = Flow(model, _metadata_from(meta["metadata"]), base,
                meta["train_loss"], meta["valid_loss"], device=device)
    if optimizer is not None and meta.get("has_opt_state"):
        with np.load(os.path.join(directory, "opt_state.npz")) as npz:
            arrays = [npz[_leaf_key(i)] for i in range(len(npz.files))]
        return flow, adam_state_from_leaves(flow.model, arrays)
    return flow
