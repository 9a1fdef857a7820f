"""Whole-run fused training: fold a FlowChain for ``ops/train_kernels.py``.

PyTorch counterpart of ``densityflows_tpu/models/fused_train.py``. Small flows
train launch-bound: a step of the plain program is a long sequence of tiny
device kernels. This module hands the whole multi-epoch run (shuffled batches,
inverse fold, hand-derived backward, Adam, per-epoch full-split evaluations)
to one ``train_run`` kernel whose block keeps the parameters and the Adam
moments in shared memory; see ``ops/train_kernels.py`` for the kernel and the
argument that Adam on the folded tensors is Adam on the originals.

Entry points:

- :func:`chain_train_fold` — fold a chain into (plan, trainable tensors,
  gradient masks, constants, ``fold_state``, ``unfold``) or raise
  :class:`UnsupportedFusedTrain`.
- :func:`train_fused` — ``train()`` on the supported surface (called through
  ``train(..., fused_kernel=True)`` or by the default routing on a CUDA
  flow): same batch order, same histories, returns the same Adam state, so a
  fused run can be continued by the plain program and the other way round.
- :func:`fold_for_step` / :func:`fused_step_reason` /
  :func:`fused_step_mesh_reason` — the same fold lowered for the grads-only
  step kernel (``ops/step_kernels.py``) that the streaming trainer and the
  data-parallel programs run per batch, and the reason it cannot take a run.

Supported: a FlowChain of RNVP / joint-RNVP / NICE couplings (activations
relu / tanh / sigmoid / identity, ``max_log_scale`` clamps included) +
trainable ActNorm + non-trainable NormalizationLayers + PermutationLayers
(folded away into the downstream layers' index maps: the kernel never
permutes), a StandardNormal base, the Adam update. A split RNVP coupling is
folded as two nets (kind ``"nvp"``); the s and t nets are not merged into one
block-diagonal net, because the zero blocks would be real work on this card.

The kernels gather batch rows through an index array, so there is no
pre-gathered batch slab. Two modes, recorded in ``flow.fused_kernel_mode``:

- ``"resident"``: ONE ``train_run`` launch runs the whole run, evaluations
  included, while the block's shared memory holds the four flat buffers
  (parameters, both moments, gradients), the constants and one batch's
  activation caches (``MAX_SHARED_BYTES``; the check is exact, from the
  lowered plan).
- ``"stream"``: past that, ``train_stream`` (``ops/stream_kernels.py``) keeps
  the state in device memory and splits each batch over many blocks; its
  envelope is the caches of one row. One launch per chunk of epochs (the
  chunks bounded by ``_STREAM_DEVICE_BUDGET``); the per-epoch histories are
  evaluated from its snapshots. A model outside both envelopes raises
  :class:`UnsupportedFusedTrain` with both reasons.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
from torch import nn

from ..ops.mlp import TensorParallelMLP
from ..ops.train_kernels import (
    MAX_SHARED_BYTES,
    TRAIN_ACTS,
    pack_train_plan,
    run_fused_train,
)
from ..utils.spans import span
from .blocks import CouplingBlock
from .chains import FlowChain
from .distributions import StandardNormal
from .fold import (
    axes_idx,
    conditioner_nets,
    fold_coupling,
    normalization_affine,
)
from .glow import ActNormLayer
from .layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
)
from .normalization import NormalizationLayer, PermutationLayer

# Device memory one streaming call may spend on what grows with its epochs:
# the int32 batch order (4 bytes per padded training row) and one snapshot of
# the folded parameters (4 bytes each) per epoch. An eighth of the H100's
# 80 GB, so the rows, the state and the partial buffers keep the rest; a
# longer run is cut into balanced chunks of epochs.
_STREAM_DEVICE_BUDGET = 80_000_000_000 // 8
# rows per chunk of the per-epoch evaluations of the snapshots
_EVAL_ROW_CHUNK = 1 << 16

__all__ = ["UnsupportedFusedTrain", "chain_train_fold", "train_fused",
           "trainable_leaves", "load_leaves_", "draw_epoch_perms",
           "FoldedStep", "fold_for_step", "fold_for_step_mesh",
           "fused_step_reason",
           "fused_step_mesh_reason"]


class UnsupportedFusedTrain(ValueError):
    """The chain / config is outside the fused-train kernel's envelope."""


def trainable_leaves(model) -> list:
    """The model's trainable tensors in the checkpoint's leaf order (the JAX
    package's pytree order with the non-trainable leaves left out). Adam
    moments are lists aligned with this one."""
    from ..utils.checkpoint import element_leaves

    return [t for t in element_leaves(model) if isinstance(t, nn.Parameter)]


def draw_epoch_perms(generator, epochs: int, n: int, shuffle: bool = True):
    """``(epochs, n)`` int64 numpy array: one row permutation per epoch, drawn
    on the host from ``generator`` (a fresh non-deterministic one when
    None); ``arange`` rows when ``shuffle`` is False."""
    if not shuffle:
        return np.broadcast_to(np.arange(n, dtype=np.int64), (epochs, n)).copy()
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    return np.stack([
        torch.randperm(n, generator=generator, device=generator.device)
        .cpu().numpy() for _ in range(epochs)]) if epochs else \
        np.zeros((0, n), np.int64)


def _inverse_order(chain):
    """The chain's layers in INVERSE execution order (the training
    direction): chain reversed, block members (layer_2, layer_1)."""
    if not isinstance(chain, FlowChain):
        raise UnsupportedFusedTrain(
            f"fused train needs a FlowChain, got {type(chain).__name__}")
    out = []
    for layer in reversed(chain.layers):
        if isinstance(layer, CouplingBlock):
            out += [layer.layer_2, layer.layer_1]
        else:
            out.append(layer)
    return out


def _check_net(net):
    if isinstance(net, TensorParallelMLP):
        raise UnsupportedFusedTrain(
            "tensor-parallel conditioners (a 'model' mesh axis): the kernel "
            "holds whole networks")
    if net.activation not in TRAIN_ACTS:
        raise UnsupportedFusedTrain(
            f"activation {net.activation!r} has no value-based derivative "
            f"in the kernel (supported: {TRAIN_ACTS})")
    if len(net.weights) < 2:
        raise UnsupportedFusedTrain("single-dense conditioners unsupported")
    for t in list(net.weights) + list(net.biases):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise UnsupportedFusedTrain(
                f"the train kernel takes float32 or bfloat16 conditioners "
                f"(got {t.dtype})")


def _f32(t):
    """A trainable tensor for the kernel: detached, float32; bfloat16
    (conditioners stored by ``cast_conditioners``) is upcast as the JAX
    package's packers upcast it, any other dtype raises."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise UnsupportedFusedTrain(
            f"the train kernel takes float32 or bfloat16 tensors (got "
            f"{t.dtype})")
    return t.detach().float()


def _unfold_net(net, folded, n, id_idx, af_idx, heads):
    """Inverse of the fold of one conditioner MLP (``fold.py``): the
    on-support entries back in the MLP's own layout, as values aligned with
    (weights..., biases...). Returns (values, folded tensors used)."""
    def join(parts, dim):
        return torch.cat(parts, dim) if len(parts) > 1 else parts[0]

    n_layers = len(net.weights)
    i = 0
    parts = []
    if n > 0:
        parts.append(folded[i])
        i += 1
    if len(id_idx) > 0:
        parts.append(folded[i][id_idx])
        i += 1
    ws = [join(parts, 0)]
    ws.extend(folded[i:i + n_layers - 2])
    i += n_layers - 2
    ws.append(join([f[:, af_idx] for f in folded[i:i + heads]], 1))
    i += heads
    bs = []
    if net.has_bias:
        bs = [folded[i + k].reshape(-1) for k in range(n_layers - 1)]
        i += n_layers - 1
        bs.append(join([f[0, af_idx] for f in folded[i:i + heads]], 0))
        i += heads
    return ws + bs, i


def _coupling_fold(layer, get, coord_map=None):
    """``fold.fold_coupling`` in the inverse direction where the kernel can
    train the layer. ``coord_map`` (an int array, kernel-frame dim per
    layer-frame dim) relabels the layer's axes into the kernel's coordinate
    frame — how PermutationLayers fold away: the kernel never permutes, the
    downstream couplings read and write the permuted dims. ``None`` is the
    identity."""
    ax = layer.axes
    if ax.transform_dim == 0 or ax.nn_input_dim == 0:
        raise UnsupportedFusedTrain("degenerate coupling axes")
    for net in conditioner_nets(layer):
        _check_net(net)
    return fold_coupling(layer, get, "inv", coord_map)


def _coupling_unfold(layer, folded, coord_map=None):
    """Values aligned with the layer's trainable leaves, sliced at the same
    kernel-frame positions the fold scattered to."""
    id_idx, af_idx = axes_idx(layer, coord_map)
    heads = 2 if isinstance(layer, JointRNVPCouplingLayer) else 1
    values, used = [], 0
    for net in conditioner_nets(layer):
        v, u = _unfold_net(net, folded[used:], layer.axes.n, id_idx, af_idx,
                           heads)
        values += v
        used += u
    return values, used


def _anorm_fold(layer, get, cmap=None):
    """ActNorm → [log_scale (1, d), bias (1, d)] in the kernel frame."""
    s = get(layer.log_scale).reshape(1, -1)
    b = get(layer.bias).reshape(1, -1)
    if s.dtype != torch.float32:
        raise UnsupportedFusedTrain(
            f"the train kernel is float32 only (got {s.dtype})")
    if cmap is not None:
        inv_m = np.argsort(cmap)
        s, b = s[:, inv_m], b[:, inv_m]
    return [s.contiguous(), b.contiguous()]


def _anorm_unfold(folded, cmap=None):
    """Values in the layer's leaf order: bias, log_scale."""
    s, b = folded[0], folded[1]
    if cmap is not None:
        s, b = s[:, cmap], b[:, cmap]
    return [b.reshape(-1), s.reshape(-1)], 2


def _affine_const(layer, cmap=None):
    """NormalizationLayer → inverse-direction (a, b, signed ldj) constants in
    the kernel frame; not trained (its data range is a buffer)."""
    if layer.x_min.dtype != torch.float32:
        raise UnsupportedFusedTrain(
            f"the train kernel is float32 only (got {layer.x_min.dtype})")
    a, b, c = normalization_affine(layer, "inv")
    if cmap is not None:
        inv_m = np.argsort(cmap)
        a, b = a[:, inv_m], b[:, inv_m]
    return [a, b, c]


def _layer_leaves(layer):
    """A trainable layer's leaves in checkpoint order."""
    if isinstance(layer, ActNormLayer):
        return [layer.bias, layer.log_scale]
    out = []
    for net in conditioner_nets(layer):
        out += list(net.weights) + [b for b in net.biases]
    return out


def chain_train_fold(chain):
    """Fold a chain for the whole-run train kernel.

    Returns ``(plan, tcounts, tparams, masks, mask_slots, cparams,
    fold_state, unfold)``. ``tparams``: the folded trainable tensors
    (detached copies); ``masks`` / ``mask_slots``: the 0/1 gradient masks of
    the scattered tensors and, per folded tensor, its mask's index or None.
    ``fold_state(values)`` folds a list of tensors aligned with
    :func:`trainable_leaves` (Adam moments) with the same embedding;
    ``unfold(folded)`` returns the values aligned with
    :func:`trainable_leaves`. Raises :class:`UnsupportedFusedTrain` outside
    the envelope.
    """
    # PermutationLayers fold away: the kernel keeps its working vector in the
    # ORIGINAL x frame and every downstream layer's dims are relabeled
    # through the accumulated coordinate map (a permutation is a frame change
    # with ldj = 0; a leftover trailing map is free because the
    # StandardNormal base is permutation-symmetric).
    cmap = None  # layer-frame dim k lives at kernel dim cmap[k]
    spec = []    # (layer, coord_map) per op that is not a permutation
    outside = []
    for layer in _inverse_order(chain):
        if isinstance(layer, PermutationLayer):
            inv = np.asarray(layer._inv(), np.int64)
            cmap = inv if cmap is None else cmap[inv]
        elif isinstance(layer, (RNVPCouplingLayer, JointRNVPCouplingLayer,
                                NICECouplingLayer, ActNormLayer,
                                NormalizationLayer)):
            spec.append((layer, cmap))
        elif type(layer).__name__ not in outside:
            outside.append(type(layer).__name__)
    if outside:
        raise UnsupportedFusedTrain(
            f"{', '.join(outside)} {'is' if len(outside) == 1 else 'are'} "
            "outside the fused-train envelope (RNVP/joint/NICE couplings + "
            "ActNorm/Normalization/Permutation only)")

    def fold(get):
        plan, tcounts, tparams, masks_dense, cparams = [], [], [], [], []
        for layer, cm in spec:
            if isinstance(layer, ActNormLayer):
                plan.append(("anorm",))
                ps, ms = _anorm_fold(layer, get, cm), [None, None]
            elif isinstance(layer, NormalizationLayer):
                plan.append(("affine",))
                ps, ms = [], []
                cparams.extend(c.contiguous()
                               for c in _affine_const(layer, cm))
            else:
                op, ps, ms = _coupling_fold(layer, get, cm)
                plan.append(op)
            tcounts.append(len(ps))
            tparams.extend(p.contiguous().clone() for p in ps)
            masks_dense.extend(ms)
        return plan, tcounts, tparams, masks_dense, cparams

    with torch.no_grad():
        plan, tcounts, tparams, masks_dense, cparams = fold(_f32)
    if not any(tcounts):
        raise UnsupportedFusedTrain("no trainable layers")

    # sparse mask slots: only scattered tensors carry masks
    mask_slots, masks = [], []
    for m in masks_dense:
        if m is None:
            mask_slots.append(None)
        else:
            mask_slots.append(len(masks))
            masks.append(m)

    leaves = trainable_leaves(chain)
    leaf_pos = {id(t): i for i, t in enumerate(leaves)}

    def unfold(folded):
        folded = list(folded)
        values = [None] * len(leaves)
        i = 0
        for (layer, cm), cnt in zip(spec, tcounts):
            if cnt == 0:
                continue
            if isinstance(layer, ActNormLayer):
                vals, used = _anorm_unfold(folded[i:i + cnt], cm)
            else:
                vals, used = _coupling_unfold(layer, folded[i:i + cnt], cm)
            if used != cnt:
                raise AssertionError((used, cnt))
            i += cnt
            targets = [t for t in _layer_leaves(layer) if t.numel()]
            vals = [v for v in vals if v.numel()]
            for t, v in zip(targets, vals):
                values[leaf_pos[id(t)]] = v.reshape(t.shape).clone()
        # zero-width bias placeholders of bias-free nets
        for k, t in enumerate(leaves):
            if values[k] is None:
                values[k] = t.detach().clone()
        return values

    def fold_state(values):
        values = list(values)
        if len(values) != len(leaves):
            raise ValueError(
                f"expected {len(leaves)} tensors aligned with the model's "
                f"trainable leaves, got {len(values)}")
        by_id = {id(t): v for t, v in zip(leaves, values)}
        with torch.no_grad():
            return fold(lambda p: by_id[id(p)].detach().to(p.device,
                                                          torch.float32))[2]

    return (tuple(plan), tuple(tcounts), tparams, masks, tuple(mask_slots),
            cparams, fold_state, unfold)


def _check_budget(packed):
    """The exact shared-memory need of the block against what one block can
    have."""
    need = packed.shared_bytes
    if need > MAX_SHARED_BYTES:
        flat = 4 * 4 * packed.n_params
        raise UnsupportedFusedTrain(
            f"the run needs {need} bytes of shared memory in one block "
            f"({flat} for parameters, both Adam moments and gradients, "
            f"{4 * packed.cache_floats} for one batch's activations and "
            f"scratch) and a block has {MAX_SHARED_BYTES}: model or batch "
            "too large for the resident whole-run kernel")


# -- the grads-only step kernel's envelope ------------------------------------

class FoldedStep:
    """A flow folded for the step kernel (``ops/step_kernels.py``): the
    lowered :class:`~..ops.step_kernels.StepPlan`, the folded tensors and the
    two maps between Adam moments on the model's leaves and on the folded
    tensors."""

    def __init__(self, step_plan, tparams, fold_state, unfold):
        self.step_plan, self.tparams = step_plan, tparams
        self.fold_state, self.unfold = fold_state, unfold


def fold_for_step(flow) -> FoldedStep:
    """Fold ``flow`` for the step kernel or raise
    :class:`UnsupportedFusedTrain`. The envelope is what the kernel can hold:
    a foldable chain, a StandardNormal base, and the activation caches of
    ONE row within a block's shared memory (the exact bytes, from the
    lowered plan; parameters and gradients stay in device memory, so their
    size does not count)."""
    from ..ops.step_kernels import StepPlan

    if not isinstance(flow.base, StandardNormal):
        raise UnsupportedFusedTrain("the step kernel supports the "
                                    "StandardNormal base only")
    (plan, tcounts, tparams, masks, mask_slots, cparams, fold_state,
     unfold) = chain_train_fold(flow.model)
    sp = StepPlan(plan, tparams, masks, mask_slots, cparams, flow.metadata.d,
                  flow.metadata.n, tcounts)
    try:
        sp.min_tile()
    except ValueError as e:
        raise UnsupportedFusedTrain(str(e)) from None
    return FoldedStep(sp, tparams, fold_state, unfold)


def fused_step_reason(flow):
    """``None`` when the step kernel can run ``flow``, else the reason it
    cannot (surfaced through ``flow.fused_decline_reason``)."""
    try:
        fold_for_step(flow)
    except UnsupportedFusedTrain as e:
        return str(e)
    return None


def fold_for_step_mesh(flow, batchsize, mesh) -> FoldedStep:
    """:func:`fold_for_step` for the data-parallel step-kernel program, which
    also needs a mesh whose only axis of more than one rank is ``data`` and a
    batch that the ranks of ``mesh`` divide evenly."""
    if any(sz > 1 for name, sz in mesh.shape.items() if name != "data"):
        raise UnsupportedFusedTrain(
            "non-DP mesh axes (fused-step DP shards 'data' only)")
    ndev = int(mesh.shape.get("data", 1))
    if batchsize % ndev:
        raise UnsupportedFusedTrain(
            f"batchsize {batchsize} not divisible by the data axis ({ndev})")
    return fold_for_step(flow)


def fused_step_mesh_reason(flow, batchsize, mesh):
    """``None`` when the data-parallel step-kernel program applies, else the
    reason it does not."""
    try:
        fold_for_step_mesh(flow, batchsize, mesh)
    except UnsupportedFusedTrain as e:
        return str(e)
    return None


def load_leaves_(model, values) -> None:
    """Copy ``values`` (aligned with :func:`trainable_leaves`) into the
    model's parameters, in place."""
    with torch.no_grad():
        for t, v in zip(trainable_leaves(model), values):
            t.copy_(v)


def train_fused(
    flow,
    data,
    *,
    epochs: int = 100,
    batchsize: int = 64,
    shuffle: bool = True,
    verbose: bool = True,
    generator=None,
    opt_state=None,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    track_best: bool = False,
    weights=None,
    skip_nonfinite: bool = False,
    _epoch_perms=None,
):
    """``train()`` on the whole-run kernel (``train(fused_kernel=True)``).

    Same contract on the supported surface: Adam(1e-3) by default, a fresh
    shuffle per epoch drawn from ``generator``, per-epoch full-split NLL
    histories appended to the flow, returns the Adam state (count + moments)
    so the run can be continued by either path. The model's parameters are
    updated in place. ``track_best=True`` returns ``(opt_state,
    best_model)`` — a copy of the model at the lowest-validation-NLL epoch,
    selected inside the kernel (in stream mode: from each chunk's
    snapshots, as the JAX package's stream mode selects it). ``weights``
    takes per-RAW-row importance weights: batch losses and both full-split
    epoch evaluations become the weighted NLL −Σw·lp/Σw. ``skip_nonfinite=True`` applies each batch
    update only when the loss and all (masked) gradients are finite; skipped
    steps leave parameters and Adam state as they are, do not advance the
    Adam step, and are counted per epoch into ``flow.skipped_updates``.

    On a CUDA flow this launches ``train_run`` once or, past its envelope,
    ``train_stream`` once per chunk of epochs (``flow.fused_kernel_mode``
    says which); on a CPU flow the wrappers run the kernels' plain versions.
    """
    from ..train import AdamState

    if not isinstance(flow.base, StandardNormal):
        raise UnsupportedFusedTrain("fused train supports the "
                                    "StandardNormal base only")
    with span("df.fold"):
        (plan, tcounts, tparams, masks, mask_slots, cparams, fold_state,
         unfold) = chain_train_fold(flow.model)

    n, nv = len(data.partition.training), len(data.partition.validation)
    if n == 0 or nv == 0:
        raise UnsupportedFusedTrain("empty training/validation split")
    d, n_cond = data.num_dimensions, data.num_conditions
    x_t, th_t, x_v, th_v, w_t, w_v = data.normalized_splits_on(
        flow.metadata, flow.device, weights)
    arrays = (x_t, th_t if n_cond else None, x_v, th_v if n_cond else None)
    w_dev = w_t, w_v

    with span("df.fold"):
        packed = pack_train_plan(plan, tparams, masks, mask_slots, cparams,
                                 d, n_cond, batchsize)
        step_plan = None
        try:
            _check_budget(packed)
        except UnsupportedFusedTrain as resident:
            # past the resident envelope: the streaming kernel, or both
            # reasons
            from ..ops.step_kernels import StepPlan
            from ..ops.stream_kernels import stream_reason

            step_plan = StepPlan(plan, tparams, masks, mask_slots, cparams,
                                 d, n_cond, tcounts)
            reason = stream_reason(step_plan)
            if reason is not None:
                raise UnsupportedFusedTrain(
                    f"{resident}; {reason}") from None

        count0 = 0
        if opt_state is not None:
            if not isinstance(opt_state, AdamState):
                raise UnsupportedFusedTrain(
                    "opt_state is not an Adam state (need count, mu, nu)")
            count0 = int(opt_state.count)
            mu = fold_state(opt_state.mu)
            nu = fold_state(opt_state.nu)
        else:
            mu = [torch.zeros_like(p) for p in tparams]
            nu = [torch.zeros_like(p) for p in tparams]

    with span("df.gather"):
        perms = (draw_epoch_perms(generator, epochs, n, shuffle)
                 if _epoch_perms is None else np.asarray(_epoch_perms))

    hp = dict(lr=lr, b1=b1, b2=b2, eps=eps)
    t0 = time.perf_counter()
    if step_plan is None:
        with span("df.enqueue"):
            p_new, mu_new, nu_new, tls, vls, best, skips = run_fused_train(
                plan, tparams, masks, mask_slots, cparams, mu, nu, *arrays,
                perms, batchsize=batchsize, count0=count0,
                track_best=track_best, w=w_dev[0], w_valid=w_dev[1],
                guard_nonfinite=skip_nonfinite, packed=packed, **hp)
        with span("df.wait"):
            tls = tls.cpu().numpy()  # the host fetch waits for the kernel
            vls = vls.cpu().numpy()
            skips = skips.cpu().numpy() if skip_nonfinite else None
        flow.fused_kernel_mode = "resident"
    else:
        p_new, mu_new, nu_new, tls, vls, best, skips = _train_stream_chunks(
            step_plan, tparams, mu, nu, arrays, w_dev, perms,
            batchsize=batchsize, count0=count0, track_best=track_best,
            guard=skip_nonfinite, verbose=verbose, hp=hp)
        flow.fused_kernel_mode = "stream"
    elapsed = time.perf_counter() - t0

    with span("df.unfold"):
        load_leaves_(flow.model, unfold(p_new))
        flow.train_loss.extend(float(v) for v in tls)
        flow.valid_loss.extend(float(v) for v in vls)
        n_skipped = 0
        if skip_nonfinite:
            n_skipped = int(skips.sum())
            flow.skipped_updates.extend(int(v) for v in skips)

        n_batches = -(-n // batchsize)
        # skipped steps keep the old state, so the Adam count only advances
        # on applied updates
        out_state = AdamState(count0 + epochs * n_batches - n_skipped,
                              unfold(mu_new), unfold(nu_new))

    if verbose and n_skipped:
        print(f"[skipped {n_skipped} non-finite updates]")
    if verbose:
        for e_i, (tl, vl) in enumerate(zip(tls, vls)):
            print(f"epoch: {len(flow.train_loss) - epochs + e_i + 1} | "
                  f"train_loss = {tl}, valid_loss = {vl}")
        sps = epochs * n / elapsed if elapsed > 0 else float("inf")
        print(f"[fused-train kernel | {elapsed:.2f}s | {sps:,.0f} samples/s]")
    if track_best:
        best_model = copy.deepcopy(flow.model)
        load_leaves_(best_model, unfold(best))
        return out_state, best_model
    return out_state


def stream_chunk_epochs(n_params, n_rows, batchsize, epochs,
                        workspace_bytes=0) -> int:
    """Epochs per ``train_stream`` launch: as many as
    ``_STREAM_DEVICE_BUDGET`` holds beside the launch's workspace (each
    epoch needs its batch order and one snapshot), the chunks then
    balanced."""
    per_epoch = 4 * (-(-n_rows // batchsize) * batchsize + n_params)
    e_max = max(1, int((_STREAM_DEVICE_BUDGET - workspace_bytes)
                       // per_epoch))
    return -(-epochs // -(-epochs // e_max))


def _train_stream_chunks(sp, tparams, mu, nu, arrays, w_dev, perms, *,
                         batchsize, count0, track_best, guard, verbose, hp):
    """The run on ``train_stream`` in balanced chunks of epochs that fit
    ``_STREAM_DEVICE_BUDGET``, the state, the Adam count and the sliced
    permutations carried from chunk to chunk; each chunk's histories
    evaluated from its snapshots. Returns what ``run_fused_train`` returns,
    the histories and skips as numpy arrays.

    ``track_best`` follows the JAX package's stream mode: per chunk the
    snapshot at ``np.argmin`` of its validation NLLs (a NaN, where the chunk
    holds one), kept when the first chunk or when below the best so far;
    the resident kernel's rule (a NaN in the history stops every later
    update) differs there."""
    from ..ops.stream_kernels import (
        eval_snapshots,
        run_fused_train_stream,
        stream_workspace_bytes,
    )

    x, th, xv, thv = arrays
    epochs, n = perms.shape
    if epochs < 1:
        raise ValueError("epochs must be at least 1")
    n_batches = -(-n // batchsize)
    chunk = stream_chunk_epochs(sp.n_params, n, batchsize, epochs,
                                stream_workspace_bytes(sp, batchsize))
    if verbose:
        print(f"[fused-train STREAMING kernel: {epochs} epochs in "
              f"{-(-epochs // chunk)} chunk(s) of <= {chunk} ({n} rows, "
              f"batch {batchsize})]")
    params, count = list(tparams), count0
    tls, vls, skips = [], [], []
    best, best_vl = None, np.inf
    for done in range(0, epochs, chunk):
        with span("df.enqueue") as enq:
            tc0 = run_fused_train_stream.tc_launches
            params, mu, nu, snaps, sk = run_fused_train_stream(
                sp.plan, params, sp.masks, sp.mask_slots, sp.cparams, mu, nu,
                x, th, perms[done:done + chunk], batchsize=batchsize,
                count0=count, w=w_dev[0], guard_nonfinite=guard,
                step_plan=sp, **hp)
            if enq.recording:
                # 1 where the launch took the tensor-core design
                enq.counts["tc"] = run_fused_train_stream.tc_launches - tc0
        with span("df.eval"):
            tl = eval_snapshots(snaps, sp.cparams, x, th, w_dev[0],
                                plan=sp.plan, row_chunk=_EVAL_ROW_CHUNK)
            vl = eval_snapshots(snaps, sp.cparams, xv, thv, w_dev[1],
                                plan=sp.plan, row_chunk=_EVAL_ROW_CHUNK)
        with span("df.wait"):
            tl, vl = tl.cpu().numpy(), vl.cpu().numpy()
            if guard:
                skips.append(sk.cpu().numpy())
        tls.append(tl)
        vls.append(vl)
        c_skips = 0
        if guard:
            c_skips = int(skips[-1].sum())
        count += len(tl) * n_batches - c_skips
        if track_best:
            arg = int(np.argmin(vl))
            if best is None or vl[arg] < best_vl:
                best = [s[arg].clone() for s in snaps]
                best_vl = float(vl[arg])
    return (params, mu, nu, np.concatenate(tls), np.concatenate(vls), best,
            np.concatenate(skips) if guard else None)
