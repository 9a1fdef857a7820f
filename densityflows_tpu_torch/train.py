"""NLL training: the plain multi-epoch program, the routing to the
whole-run kernel, and the data-parallel programs.

PyTorch counterpart of ``densityflows_tpu/train.py``. Two paths run a
single-device ``train`` call:

- the **plain program** (:func:`make_train_program`): an eager loop on the
  flow's device — per epoch a fresh row permutation drawn on the host, per
  batch gather → inverse pass → masked NLL → autograd → optimizer update,
  then the full-split train and validation NLL. It handles every optimizer
  and every layer, and it is the reference the kernel is held against;
- the **whole-run kernels** (``models/fused_train.py``): the same run as one
  ``train_run`` launch for chains and configs inside its shared-memory
  envelope, else as one ``train_stream`` launch per chunk of epochs (the
  stream mode: parameters and moments in device memory).

DataLoader semantics: fresh shuffle each epoch, final partial batch kept —
as padded gather indices (row 0) plus a loss mask. Loss histories are
appended to ``flow.train_loss`` / ``flow.valid_loss`` after the run. The
model's parameters are updated in place.

Randomness is an explicit ``torch.Generator`` (``generator=``); the
permutations are drawn on the host from it. The chunked loops (checkpoints,
early stopping, ``debug``) derive each chunk's generator from one draw of the
caller's generator and the chunk's position, so a resumed run replays the
shuffle sequence of an uninterrupted one.

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh`` around a
``torch.distributed`` group): every rank holds the data set and the model,
works on ITS rows of each batch with the GLOBAL loss denominator, and the
ranks sum loss and gradients before the update, so a run equals the
single-device one batch for batch. Two programs do that:

- the **step-kernel program** (:func:`make_fused_step_mesh_program`): per
  batch the grads-only kernel ``step_grads`` (``ops/step_kernels.py``) on
  folded parameters, one all-reduce of the packed gradient and loss, then
  Adam over the flat folded buffer in plain tensor operations
  (``flow.trained_path == "fused-step-mesh"``);
- the **plain program** with an all-reduce of the autograd gradients, for
  runs outside the kernel's envelope.

Tensor parallelism (a mesh with a ``model`` axis, ``make_mesh((D, T),
("data", "model"))``, and a chain placed by
``parallel.mesh.shard_params_tp``): the plain program, its gradients summed
over the ``data`` axis only — the Megatron operators of ``ops/mlp.py`` make
the ``model`` axis's replicated leaves agree by construction. The step
kernel declines such a mesh ("non-DP mesh axes"), in
``flow.fused_decline_reason``.

Graphed steps: on a CUDA device the plain program replays each Adam step
from three CUDA graphs (:class:`_GraphedSteps`: the batch loss, its
gradient, the update written back to the moments; made once per model and
batch shape, batch norm's running statistics restored after the warm-up)
where the chain holds a spline coupling or an LU linear layer (which no
kernel runs, so no kernel's check holds their eager steps), every element
is of a type whose forward enqueues no host copy, the optimizer is
``adam(...)`` and no mesh, remat, mixed precision, skipped step or
per-layer coupling kernel is in play (:func:`_graph_reason`); the
evaluations run eagerly. A step then costs the host a few launches instead
of one per operation: the same kernels, in the same order. The model keeps
the graphs of its last two batch shapes, and their memory pool (a step's
activations: about 11 GB for Dingo's flow at batch 4096), for the calls
that follow, until its trainable leaves are replaced or it is deleted; a
deep copy or a pickle starts without them.

Precision and memory options of the plain program: ``remat=True`` runs
each layer of a chain under ``torch.utils.checkpoint`` (its activations are
recomputed in the backward pass), ``mixed_precision=True`` casts the
conditioner networks to bfloat16 inside the loss
(``models.layers.cast_conditioners``); master parameters, gradients, the
optimizer state and the epoch histories stay float32. The kernels implement
neither: under ``"auto"`` such a run takes the plain program with the
decline recorded, and ``fused_kernel=True`` with either raises.

While a ``torch.profiler`` session records, a call records its stages as
spans of ``utils/spans.py`` under its ``df.train`` root: ``df.gather``
(``dev`` where it picks the splits' rows:
``DataArrays.normalized_splits_on``), ``df.fold``, ``df.upload``
(``bytes``), ``df.enqueue``, ``df.eval``, ``df.wait``, ``df.unfold`` on the
kernel path; ``df.upload`` and ``df.gather``, per step ``df.forward``
(``rows``), ``df.backward`` and ``df.adam``, and per epoch ``df.eval`` in
the plain program.

Batch norm (``ops/mlp.py::BatchNorm``, in nflows' residual conditioners):
a plain step's batch loss normalises by the batch's own statistics and
moves the running ones (``batch_statistics``); every evaluation, in
training and outside it, uses the running statistics. The plain program
hands such a model the last, partial batch of an epoch unpadded, so that
its statistics are those of the real rows. Data-parallel and remat runs
of such a model raise: a rank's statistics would be its shard's, and a
recomputed forward would move the running statistics twice.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
import warnings
from typing import Iterator

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .data import DataArrays, _put, normalize_input
from .models.flow import Flow, _chain_eval
from .models.fused_train import (
    UnsupportedFusedTrain,
    draw_epoch_perms,
    fold_for_step_mesh,
    load_leaves_,
    train_fused,
    trainable_leaves,
)
from .ops.mlp import (
    MLP, BatchNorm, ResidualBlock, ResidualNet, batch_statistics,
    has_batch_norm,
)
from .ops.step_kernels import folded_nll
from .parallel.mesh import check_mesh
from .utils.spans import span

__all__ = [
    "train", "evaluate", "make_train_step", "make_train_program",
    "make_fused_step_fn", "make_fused_step_mesh_program",
    "batch_iterator", "Adam", "AdamState", "adam", "masked_nll_loss",
]


def _bias_corrections(b1, b2, count):
    """``1 − bᵗ`` for both moments, in float32 like ``optax.adam``."""
    return (float(np.float32(1.0) - np.float32(b1) ** np.float32(count)),
            float(np.float32(1.0) - np.float32(b2) ** np.float32(count)))


@dataclasses.dataclass
class AdamState:
    """Adam's state: the number of applied updates and the two moment lists,
    aligned with ``trainable_leaves(model)``. It holds what
    ``optax.adam``'s state holds (``utils/checkpoint.py`` writes it in that
    layout)."""

    count: int
    mu: list
    nu: list


class Adam:
    """Adam with introspectable hyperparameters, equal to ``optax.adam``:
    bias-corrected moments, ``eps`` outside the square root, ``eps_root`` 0,
    then a step of ``-learning_rate``.

    ``init(params)`` / ``update(grads, state, params=None)`` work on lists of
    tensors and return new tensors; any object with these two methods is an
    optimizer for the plain program. Only this exact class rides the
    whole-run kernel, which implements its update.
    """

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(self, grads, state: AdamState, params=None):
        count = state.count + 1
        updates, mu, nu = self._step(
            list(grads), list(state.mu), list(state.nu),
            *_bias_corrections(self.b1, self.b2, count))
        return updates, AdamState(count, mu, nu)

    def _step(self, grads, mu, nu, bc1, bc2):
        """``(updates, new mu, new nu)`` from the moments ``mu`` / ``nu``
        (left as they are) and the bias corrections ``bc1`` / ``bc2``:
        numbers, or device scalars where a graphed step replays it."""
        # one multi-tensor launch per operation over all the leaves; each
        # element is rounded as b1·m + (1 − b1)·g, b2·v + (1 − b2)·g²,
        # −lr · ((m / bc1) / (√(v / bc2) + eps)) written out leaf by leaf
        mu = torch._foreach_add(torch._foreach_mul(mu, self.b1),
                                torch._foreach_mul(grads, 1.0 - self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(nu, self.b2),
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1.0 - self.b2))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        updates = list(torch._foreach_div(torch._foreach_div(mu, bc1), den))
        torch._foreach_mul_(updates, -self.learning_rate)
        return updates, list(mu), list(nu)

    def __repr__(self):
        return (f"adam(learning_rate={self.learning_rate}, b1={self.b1}, "
                f"b2={self.b2}, eps={self.eps})")


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """Kernel-routable Adam (see :class:`Adam`)."""
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps)


def _write_metrics(metrics_log, flow, epochs):
    """Append the last ``epochs`` history entries to the JSONL metrics log
    (shared by the plain program and the kernel path)."""
    from .utils.logging import MetricsLogger

    logger = MetricsLogger(metrics_log)
    epoch0 = len(flow.train_loss) - epochs
    # slice from an explicit start: [-0:] would re-log the whole history
    for e, (tl, vl) in enumerate(zip(flow.train_loss[epoch0:],
                                     flow.valid_loss[epoch0:])):
        logger.write(epoch=epoch0 + e + 1, train_nll=float(tl),
                     valid_nll=float(vl), trained_path=flow.trained_path)


def masked_nll_loss(model, base, x, theta, mask, *, remat: bool = False,
                    mixed_precision: bool = False):
    """NLL over valid rows only; ``mask`` zeroes padded rows so partial
    batches keep their shape.

    ``mask`` generalizes to per-row importance WEIGHTS: the loss is
    −Σ mᵢ·log p(xᵢ|θᵢ) / max(Σ mᵢ, 1e-12), so non-0/1 masks give the
    importance-weighted NLL and the all-ones mask the plain one. The epsilon
    only guards the all-padded batch, whose numerator is exactly 0.

    ``remat=True`` runs each layer's inverse of a chain (the whole model's,
    for any other model) under ``torch.utils.checkpoint``: the backward pass
    recomputes one layer's activations at a time instead of keeping the
    whole chain's. ``mixed_precision=True`` casts the conditioner networks
    to bfloat16 inside the loss (``cast_conditioners``); the gradients come
    back to the float32 parameters through the cast, and s / t, ldj and the
    loss stay float32.
    """
    z, ldj = _loss_inverse(model, x, theta, remat, mixed_precision)
    per_sample = base.log_prob(z) + ldj
    denom = torch.clamp(mask.sum(), min=1e-12)
    return -(per_sample * mask).sum() / denom


def _loss_inverse(model, x, theta, remat=False, mixed_precision=False):
    """``model.inverse(x, theta)`` under the loss options of
    :func:`masked_nll_loss`."""
    if mixed_precision:
        from .models.layers import _cast_in_graph

        model = _cast_in_graph(model, torch.bfloat16)
    if not remat:
        return model.inverse(x, theta)
    from .models.chains import FlowChain

    if isinstance(model, FlowChain):
        # one layer at a time, in the inverse order, as FlowChain.inverse
        y, ldj = x, None
        for layer in reversed(model.layers):
            y, ldj_i = checkpoint(layer.inverse, y, theta,
                                  use_reentrant=False)
            ldj = ldj_i if ldj is None else ldj + ldj_i
        return y, ldj
    return checkpoint(model.inverse, x, theta, use_reentrant=False)


def _eval_nll(model, base, x, theta):
    """Full-array NLL without gradients; a fusable chain on a CUDA device
    goes through the ``chain_apply`` kernel."""
    with torch.no_grad():
        z, ldj = _chain_eval(model, x, theta, "inv")
        return -(base.log_prob(z) + ldj).mean()


def _global_denominator(mask, mesh, denom=None):
    """``Σ mask`` over the GLOBAL batch: this rank's sum, summed over the
    ranks of ``mesh``; a ``denom`` handed in is taken as global already."""
    if denom is None:
        denom = mask.sum()
        if mesh is not None:
            mesh.all_reduce_(denom)
    return denom


def _autograd(model, loss_fn, rows=None):
    """``loss_fn()`` and its autograd gradients with respect to the model's
    trainable leaves (zeros where a leaf is empty or unused): ``(detached
    loss, leaves, grads)``; ``rows`` counts the batch's rows in the
    ``df.forward`` span."""
    leaves = trainable_leaves(model)
    wrt = [p for p in leaves if p.numel()]
    with torch.enable_grad():
        with span("df.forward") as s:
            if s.recording and rows is not None:
                s.counts["rows"] = int(rows)
            loss = loss_fn()
        with span("df.backward"):
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = [(next(got) if p.numel() else None) for p in leaves]
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), leaves, grads


class _GraphCache(dict):
    """A model's graphed steps; a copy of the model starts without any (the
    graphs hold the original's tensors)."""

    def __deepcopy__(self, memo):
        return _GraphCache()

    def __reduce__(self):
        return (_GraphCache, ())


def _graph_reason(model, base, optimizer) -> str | None:
    """Why the plain program's steps of ``model`` are not replayed from
    CUDA graphs (None: they are): the chain must hold a spline coupling or
    an LU linear layer, every element must be of a type whose forward and
    backward enqueue no host copy and no host wait, every parameter
    non-empty, and the optimizer this package's Adam."""
    from .models.blocks import CouplingBlock
    from .models.chains import FlowChain
    from .models.distributions import StandardNormal
    from .models.glow import ActNormLayer, LULinearLayer
    from .models.layers import (
        NICECouplingLayer, RNVPCouplingLayer, RQSCouplingLayer, use_fused)
    from .models.normalization import NormalizationLayer, PermutationLayer

    if type(optimizer) is not Adam:
        return "an optimizer other than adam(...)"
    if use_fused(0):
        return "per-layer coupling kernels (set_fused_kernels(True))"
    if not isinstance(base, StandardNormal):
        return f"base {type(base).__name__}"
    safe = (FlowChain, CouplingBlock, RNVPCouplingLayer, NICECouplingLayer,
            RQSCouplingLayer, LULinearLayer, PermutationLayer, ActNormLayer,
            NormalizationLayer, MLP, ResidualNet, ResidualBlock, BatchNorm,
            torch.nn.ModuleList, torch.nn.ParameterList)
    for m in model.modules():
        if type(m) not in safe:
            return f"{type(m).__name__} is not known to be graph-safe"
    if not any(isinstance(m, (RQSCouplingLayer, LULinearLayer))
               for m in model.modules()):
        return ("no spline coupling or LU linear layer: the chain's eager "
                "steps are what the kernels' checks hold them against")
    if any(p.numel() == 0 for p in model.parameters()):
        return "an empty parameter"
    return None


class _GraphedSteps:
    """A model's Adam steps replayed from CUDA graphs. Per batch shape three
    graphs over static inputs: the batch loss (batch norm in train mode),
    its gradient (``torch.autograd.grad``) and :meth:`Adam._step` with its
    add, written back to moments that the shapes share. A shape's graphs are made at its first
    step (two warm-up passes of the loss and its gradient, batch norm's
    running statistics put back after them, then the captures); the model
    keeps them (``_graph_cache``: the last two shapes) while its parameters
    stay where they are and the optimizer's hyperparameters stay the
    same."""

    def __init__(self, model, optimizer, leaves, key):
        self.model, self.opt, self.leaves, self.key = (model, optimizer,
                                                       leaves, key)
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.bc = [torch.ones((), device=leaves[0].device) for _ in range(2)]
        self.count = 0
        self.shapes = {}

    @classmethod
    def of(cls, model, optimizer):
        leaves = trainable_leaves(model)
        key = (tuple(p.data_ptr() for p in leaves), optimizer.learning_rate,
               optimizer.b1, optimizer.b2, optimizer.eps)
        cache = model.__dict__.setdefault("_graph_cache", _GraphCache())
        steps = cache.get("steps")
        if steps is None or steps.key != key:
            cache.clear()
            steps = cache["steps"] = cls(model, optimizer, leaves, key)
        return steps

    def load(self, opt_state):
        """Continue ``opt_state`` (None: zero moments, no step yet)."""
        if opt_state is None:
            torch._foreach_zero_(self.mu)
            torch._foreach_zero_(self.nu)
            self.count = 0
        else:
            torch._foreach_copy_(self.mu, list(opt_state.mu))
            torch._foreach_copy_(self.nu, list(opt_state.nu))
            self.count = int(opt_state.count)

    def state(self):
        """A copy of the state, as :meth:`Adam.update` returns one."""
        return AdamState(self.count, list(torch._foreach_mul(self.mu, 1.0)),
                         list(torch._foreach_mul(self.nu, 1.0)))

    def _capture(self, base, x, theta, mask):
        model = self.model
        static = [t.clone() for t in (x, theta, mask)]
        saved = [b.detach().clone() for b in model.buffers()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), batch_statistics(model), \
                torch.enable_grad():
            for _ in range(2):
                torch.autograd.grad(masked_nll_loss(model, base, *static),
                                    self.leaves)
        torch.cuda.current_stream().wait_stream(side)
        if saved:
            with torch.no_grad():
                torch._foreach_copy_(list(model.buffers()), saved)
        pool = torch.cuda.graph_pool_handle()
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        with batch_statistics(model), torch.enable_grad():
            with torch.cuda.graph(graphs[0], pool=pool):
                loss = masked_nll_loss(model, base, *static)
            with torch.cuda.graph(graphs[1], pool=pool):
                grads = torch.autograd.grad(loss, self.leaves)
        with torch.cuda.graph(graphs[2], pool=pool), torch.no_grad():
            updates, mu, nu = self.opt._step(list(grads), self.mu, self.nu,
                                             *self.bc)
            torch._foreach_copy_(self.mu, mu)
            torch._foreach_copy_(self.nu, nu)
            torch._foreach_add_(self.leaves, updates)
        # the graphs' outputs stay referenced with them
        return static, graphs, (loss.detach(), grads)

    def step(self, base, x, theta, rows, mask):
        """One Adam step on the rows ``rows`` of ``x`` / ``theta``."""
        key = (int(rows.shape[0]), tuple(x.shape[1:]), tuple(theta.shape[1:]))
        entry = self.shapes.get(key)
        if entry is None:
            if len(self.shapes) >= 2:
                del self.shapes[next(iter(self.shapes))]
            entry = self.shapes[key] = self._capture(
                base, x[rows], theta[rows], mask)
        static, graphs, _ = entry
        with span("df.forward") as s:
            if s.recording:
                s.counts["rows"] = int(rows.shape[0])
            torch.index_select(x, 0, rows, out=static[0])
            torch.index_select(theta, 0, rows, out=static[1])
            static[2].copy_(mask)
            graphs[0].replay()
        with span("df.backward"):
            graphs[1].replay()
        with span("df.adam"):
            self.count += 1
            for t, v in zip(self.bc, _bias_corrections(
                    self.opt.b1, self.opt.b2, self.count)):
                t.fill_(v)
            graphs[2].replay()


def _loss_and_grads(model, base, x, theta, mask, mesh=None, denom=None,
                    remat=False, mixed_precision=False):
    """Loss and autograd gradients of one batch. With a ``mesh``, ``x`` is
    this rank's shard: the loss is normalized by the global denominator, and
    loss and gradients are summed over the ranks (one all-reduce of one
    buffer), which gives every rank the whole batch's values. ``remat`` /
    ``mixed_precision``: as in :func:`masked_nll_loss`. Batch norm takes the
    statistics of the rows of ``x``."""
    def loss_fn():
        if mesh is None and denom is None:
            return masked_nll_loss(model, base, x, theta, mask, remat=remat,
                                   mixed_precision=mixed_precision)
        z, ldj = _loss_inverse(model, x, theta, remat, mixed_precision)
        den = torch.clamp(_global_denominator(mask, mesh, denom), min=1e-12)
        return -((base.log_prob(z) + ldj) * mask).sum() / den

    with batch_statistics(model):
        loss, leaves, grads = _autograd(model, loss_fn, x.shape[0])
    if mesh is not None:
        loss, leaves, grads = _reduce_grads(mesh, loss, leaves, grads)
    return loss, leaves, grads


def _apply_update(optimizer, grads, opt_state, leaves):
    """One optimizer update of ``leaves``, in place, in a ``df.adam`` span;
    returns the new state."""
    with span("df.adam"):
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        with torch.no_grad():
            torch._foreach_add_(leaves, list(updates))
    return opt_state


def _reduce_grads(mesh, loss, leaves, grads):
    """Loss and gradients summed over the ``data`` axis of ``mesh``: one
    all-reduce of one packed buffer."""
    buf = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    mesh.all_reduce_(buf)
    sizes = [g.numel() for g in grads]
    grads = [c.view(g.shape) for c, g in
             zip(torch.split(buf[:-1], sizes), grads)]
    return buf[-1], leaves, grads


def _all_finite(loss, grads) -> bool:
    return bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


def make_train_step(optimizer, *, remat: bool = False,
                    mixed_precision: bool = False, mesh=None):
    """Single-batch step (loss + gradients + update) for callers that feed
    batches from their own pipeline: ``step(model, opt_state, base, x,
    theta, mask, denom=None) → (model, opt_state, loss)``. The model is
    updated in place.

    With a ``mesh`` the step is data-parallel: every rank passes ITS rows of
    the batch, the loss is normalized by the global ``Σ mask`` (``denom``
    when the caller has it already), and the autograd gradients are summed
    over the ranks before the update; the returned loss is the global one.
    ``remat`` / ``mixed_precision``: as in :func:`masked_nll_loss`."""
    check_mesh(mesh)

    def train_step(model, opt_state, base, x, theta, mask, denom=None):
        loss, leaves, grads = _loss_and_grads(model, base, x, theta, mask,
                                              mesh, denom, remat,
                                              mixed_precision)
        opt_state = _apply_update(optimizer, grads, opt_state, leaves)
        return model, opt_state, loss

    return train_step


def _batch_order(x, batchsize, epochs, shuffle, generator, epoch_perms):
    """The batches of a multi-epoch program over the rows of ``x``:
    ``(n_batches, idx, pad_mask)`` with ``idx`` ``(epochs, n_batches ·
    batchsize)`` row indices (each epoch's permutation, drawn from
    ``generator`` unless ``epoch_perms`` gives it, padded with row 0) and
    ``pad_mask`` 1 on real rows, 0 on the padding, both on ``x``'s device."""
    n = x.shape[0]
    n_batches = -(-n // batchsize)
    n_pad = n_batches * batchsize
    perms = (draw_epoch_perms(generator, epochs, n, shuffle)
             if epoch_perms is None else np.asarray(epoch_perms))
    if perms.shape != (epochs, n):
        raise ValueError(
            f"epoch_perms must have shape {(epochs, n)}, got {perms.shape}")
    idx = np.zeros((epochs, n_pad), np.int64)
    idx[:, :n] = perms
    idx = torch.as_tensor(idx, device=x.device)
    pad_mask = (torch.arange(n_pad, device=x.device) < n).to(x.dtype)
    return n_batches, idx, pad_mask


def make_train_program(
    optimizer,
    batchsize: int,
    epochs: int,
    shuffle: bool = True,
    *,
    remat: bool = False,
    mixed_precision: bool = False,
    weighted: bool = False,
    track_best: bool = False,
    guard_nonfinite: bool = False,
    mesh=None,
    graphed: bool = False,
):
    """Build the plain multi-epoch training program.

    Returns ``fn(model, opt_state, base, x, theta, x_valid, theta_valid,
    generator, *, epoch_perms=None) → (model, opt_state, train_losses,
    valid_losses)``; the losses are per-epoch full-split NLLs (numpy
    float32), taken after the epoch's last batch. ``x`` / ``theta`` and the
    validation arrays are tensors on the model's device. The model is updated
    in place and returned. ``epoch_perms`` ``(epochs, n)`` replaces the
    permutations drawn from ``generator``. Extensions:

    - ``weighted=True``: the program takes per-row importance weights —
      ``fn(model, opt_state, base, x, theta, w, x_valid, theta_valid,
      w_valid, generator)`` — and every batch loss and both full-split epoch
      evaluations become the weighted NLL.
    - ``track_best=True``: appends ``best_model`` to the outputs, a copy of
      the model at the epoch with the lowest validation NLL.
    - ``guard_nonfinite=True``: appends ``skips`` (per-epoch int counts) —
      each batch update is applied only if the loss and every gradient are
      finite; a skipped step leaves parameters and optimizer state as they
      are.
    - ``mesh``: the data-parallel program. Every rank passes the same
      arrays, permutations and model; of each batch a rank works on its own
      rows (``parallel.mesh.host_local_rows``) and the ranks sum loss and
      gradients, so every rank applies the whole batch's update. The
      full-split evaluations run on every rank in full.
    - ``remat`` / ``mixed_precision``: the batch losses as in
      :func:`masked_nll_loss`; the epoch evaluations stay plain float32
      (the histories are the record).

    A model with batch norm gets the last, partial batch of an epoch
    unpadded (its statistics over the real rows only). ``graphed=True``
    replays each step from CUDA graphs (module docstring; the caller checks
    :func:`_graph_reason`).
    """
    if graphed and (mesh is not None or remat or mixed_precision
                    or guard_nonfinite or type(optimizer) is not Adam):
        raise ValueError("graphed steps run Adam on one device without "
                         "remat, mixed precision or skipped steps")
    check_mesh(mesh)
    local = slice(None)
    if mesh is not None:
        from .parallel.mesh import host_local_rows

        local = host_local_rows(mesh, batchsize)

    def body(model, opt_state, base, x, theta, w, x_valid, theta_valid,
             w_valid, generator, epoch_perms):
        n, nv = x.shape[0], x_valid.shape[0]
        n_batches, idx, pad_mask = _batch_order(
            x, batchsize, epochs, shuffle, generator, epoch_perms)
        ones_t, ones_v = x.new_ones(n), x.new_ones(nv)
        # the real rows of the last batch, for a model with batch norm
        last = n - (n_batches - 1) * batchsize \
            if has_batch_norm(model) else batchsize
        tls, vls, skips = [], [], []
        steps = None
        if graphed:
            steps = _GraphedSteps.of(model, optimizer)
            steps.load(opt_state)
        best_vl = float("inf")
        best_values = ([p.detach().clone() for p in trainable_leaves(model)]
                       if track_best else None)
        for e in range(epochs):
            e_skips = 0
            for b in range(n_batches):
                size = last if b == n_batches - 1 else batchsize
                sl = slice(b * batchsize, b * batchsize + size)
                rows = idx[e, sl][local]
                m = pad_mask[sl][local]
                if weighted:
                    m = m * w[rows]
                if steps is not None:
                    steps.step(base, x, theta, rows, m)
                    continue
                loss, leaves, grads = _loss_and_grads(
                    model, base, x[rows], theta[rows], m, mesh,
                    remat=remat, mixed_precision=mixed_precision)
                if guard_nonfinite and not _all_finite(loss, grads):
                    e_skips += 1
                    continue
                opt_state = _apply_update(optimizer, grads, opt_state,
                                          leaves)
            with span("df.eval"), torch.no_grad():
                tl = float(masked_nll_loss(model, base, x, theta,
                                           w if weighted else ones_t))
                vl = float(masked_nll_loss(model, base, x_valid, theta_valid,
                                           w_valid if weighted else ones_v))
            if track_best and vl < best_vl:   # false on NaN
                best_vl = vl
                best_values = [p.detach().clone()
                               for p in trainable_leaves(model)]
            tls.append(tl)
            vls.append(vl)
            skips.append(e_skips)
        if steps is not None:
            opt_state = steps.state()
        out = [model, opt_state, np.asarray(tls, np.float32),
               np.asarray(vls, np.float32)]
        if track_best:
            best_model = copy.deepcopy(model)
            load_leaves_(best_model, best_values)
            out.append(best_model)
        if guard_nonfinite:
            out.append(np.asarray(skips, np.int32))
        return tuple(out)

    if weighted:
        def train_program(model, opt_state, base, x, theta, w, x_valid,
                          theta_valid, w_valid, generator, *,
                          epoch_perms=None):
            return body(model, opt_state, base, x, theta, w, x_valid,
                        theta_valid, w_valid, generator, epoch_perms)
    else:
        def train_program(model, opt_state, base, x, theta, x_valid,
                          theta_valid, generator, *, epoch_perms=None):
            return body(model, opt_state, base, x, theta, None, x_valid,
                        theta_valid, None, generator, epoch_perms)
    return train_program


# -- the step-kernel programs ----------------------------------------------------

def _adam_hp(lr, b1, b2, eps):
    return dict(lr=float(lr), b1=float(b1), b2=float(b2), eps=float(eps))


def _folded_adam_(flat_p, state: AdamState, g, hp) -> None:
    """One Adam update over the flat folded buffers, in place: ``state``
    holds the count and the two moments as one flat tensor each."""
    count = state.count + 1
    bc1, bc2 = _bias_corrections(hp["b1"], hp["b2"], count)
    mu, nu = state.mu[0], state.nu[0]
    mu.mul_(hp["b1"]).add_(g, alpha=1.0 - hp["b1"])
    nu.mul_(hp["b2"]).addcmul_(g, g, value=1.0 - hp["b2"])
    flat_p.addcdiv_(mu, (nu / bc2).sqrt_().add_(hp["eps"]),
                    value=-hp["lr"] / bc1)
    state.count = count


def _sharded_grads(mesh, step_plan, flat_p, xb, thb, mb, denom=None):
    """The packed gradient and loss (``StepPlan.loss_and_grads``) of the
    GLOBAL batch from this rank's rows: the kernel with the global
    denominator, then one sum over the ranks."""
    out = step_plan.loss_and_grads(
        flat_p, xb, thb, mb, denom=_global_denominator(mb, mesh, denom))
    if mesh is not None:
        mesh.all_reduce_(out)
    return out


def make_fused_step_fn(mesh, step_plan, *, lr=1e-3, b1=0.9, b2=0.999,
                       eps=1e-8, guard_nonfinite=False):
    """Per-BATCH step on the grads-only kernel, for host-driven loops (the
    streaming trainer): local kernel with the global denominator → sum of the
    packed gradient and loss over the ranks of ``mesh`` (``None``: one
    device, no collective) → Adam over the flat folded buffer.

    ``step_plan``: the flow's plan lowered once
    (``models.fused_train.fold_for_step``). Returns ``step(flat_p, fstate,
    xb, thb, mask, denom=None) → (flat_p, fstate, global_loss)``; ``flat_p``
    and ``fstate`` (an :class:`AdamState` whose moments are one flat tensor
    each) are updated in place. With ``guard_nonfinite`` an update is applied
    only when the summed loss and gradients are finite (the same decision on
    every rank); ``step.skipped`` counts the others."""
    hp = _adam_hp(lr, b1, b2, eps)
    n_params = step_plan.n_params

    def step(flat_p, fstate, xb, thb, mb, denom=None):
        out = _sharded_grads(mesh, step_plan, flat_p, xb, thb, mb, denom)
        loss = out[n_params]
        if guard_nonfinite and not bool(torch.isfinite(out).all()):
            step.skipped += 1
            return flat_p, fstate, loss
        _folded_adam_(flat_p, fstate, out[:n_params], hp)
        return flat_p, fstate, loss

    step.skipped = 0
    return step


def make_fused_step_mesh_program(
    mesh, step_plan, batchsize, epochs, shuffle=True, *, lr=1e-3, b1=0.9,
    b2=0.999, eps=1e-8, weighted=False, track_best=False,
    guard_nonfinite=False,
):
    """Data-parallel train program on the grads-only step kernel.

    Per batch every rank runs ``step_grads`` on its rows with the global
    denominator, the packed gradient and loss are summed over the ranks, and
    the Adam update runs in plain tensor operations on the replicated flat
    FOLDED parameter buffer. The per-epoch full-split evaluations use
    ``folded_nll``. Shuffle and batch semantics are those of
    :func:`make_train_program` (same permutations, same batch composition).

    Returns ``fn(flat_p, fstate, x, theta[, w], x_valid, theta_valid
    [, w_valid], generator, *, epoch_perms=None) → (flat_p, fstate, tls, vls
    [, best_flat_p][, skips])`` — the output contract of
    :func:`make_train_program` on the flat folded buffer. ``flat_p`` and
    ``fstate`` are updated in place."""
    from .parallel.mesh import host_local_rows

    sp = step_plan
    local = host_local_rows(mesh, batchsize) if mesh is not None \
        else slice(None)
    step = make_fused_step_fn(mesh, sp, lr=lr, b1=b1, b2=b2, eps=eps,
                              guard_nonfinite=guard_nonfinite)

    def body(flat_p, fstate, x, theta, w, x_valid, theta_valid, w_valid,
             generator, epoch_perms):
        n, nv = x.shape[0], x_valid.shape[0]
        n_batches, idx, pad_mask = _batch_order(
            x, batchsize, epochs, shuffle, generator, epoch_perms)
        w_t = w if weighted else x.new_ones(n)
        w_v = w_valid if weighted else x.new_ones(nv)
        tls, vls, skips = [], [], []
        best_vl, best = float("inf"), (flat_p.clone() if track_best else None)
        for e in range(epochs):
            before = step.skipped
            for b in range(n_batches):
                sl = slice(b * batchsize, (b + 1) * batchsize)
                rows = idx[e, sl][local]
                m = pad_mask[sl][local]
                if weighted:
                    m = m * w[rows]
                step(flat_p, fstate, x[rows], theta[rows], m)
            tp = sp.views(flat_p)
            tl = float(folded_nll(tp, sp.cparams, x, theta, w_t,
                                  plan=sp.plan))
            vl = float(folded_nll(tp, sp.cparams, x_valid, theta_valid, w_v,
                                  plan=sp.plan))
            if track_best and vl < best_vl:   # false on NaN
                best_vl, best = vl, flat_p.clone()
            tls.append(tl)
            vls.append(vl)
            skips.append(step.skipped - before)
        out = [flat_p, fstate, np.asarray(tls, np.float32),
               np.asarray(vls, np.float32)]
        if track_best:
            out.append(best)
        if guard_nonfinite:
            out.append(np.asarray(skips, np.int32))
        return tuple(out)

    if weighted:
        def program(flat_p, fstate, x, theta, w, x_valid, theta_valid,
                    w_valid, generator, *, epoch_perms=None):
            return body(flat_p, fstate, x, theta, w, x_valid, theta_valid,
                        w_valid, generator, epoch_perms)
    else:
        def program(flat_p, fstate, x, theta, x_valid, theta_valid,
                    generator, *, epoch_perms=None):
            return body(flat_p, fstate, x, theta, None, x_valid, theta_valid,
                        None, generator, epoch_perms)
    return program


def _fold_adam_state(folded, opt_state):
    """The Adam state of a flow's leaves as the flat folded state
    (zeros when ``opt_state`` is None)."""
    sp = folded.step_plan
    if opt_state is None:
        flat = sp.flatten(folded.tparams)
        return AdamState(0, [torch.zeros_like(flat)], [torch.zeros_like(flat)])
    return AdamState(int(opt_state.count),
                     [sp.flatten(folded.fold_state(opt_state.mu))],
                     [sp.flatten(folded.fold_state(opt_state.nu))])


def _unfold_adam_state(folded, fstate) -> AdamState:
    sp = folded.step_plan
    return AdamState(fstate.count, folded.unfold(sp.unflatten(fstate.mu[0])),
                     folded.unfold(sp.unflatten(fstate.nu[0])))


def _run_fused_step_mesh(flow, mesh, folded, batchsize, epochs, shuffle,
                         generator, xt, tht, xv, thv, wt, wv, hp, opt_state,
                         track_best, guard, verbose, metrics_log,
                         epoch_perms):
    """Run the data-parallel step-kernel program and translate in and out of
    the folded parameter space."""
    from .parallel.mesh import put_replicated

    sp = folded.step_plan
    flat_p = sp.flatten(folded.tparams)
    fstate = _fold_adam_state(folded, opt_state)
    # the fold ran on every rank's own copy: make the copies one
    put_replicated(mesh, [flat_p, fstate.mu[0], fstate.nu[0]])

    program = make_fused_step_mesh_program(
        mesh, sp, batchsize, epochs, shuffle, weighted=wt is not None,
        track_best=track_best, guard_nonfinite=guard, **hp)
    t0 = time.perf_counter()
    if wt is not None:
        out = program(flat_p, fstate, xt, tht, wt, xv, thv, wv, generator,
                      epoch_perms=epoch_perms)
    else:
        out = program(flat_p, fstate, xt, tht, xv, thv, generator,
                      epoch_perms=epoch_perms)
    flat_p, fstate, tls, vls = out[:4]
    rest = list(out[4:])
    best_flat = rest.pop(0) if track_best else None
    skips = rest.pop(0) if guard else None
    elapsed = time.perf_counter() - t0

    load_leaves_(flow.model, folded.unfold(sp.unflatten(flat_p)))
    flow.trained_path = "fused-step-mesh"
    flow.fused_decline_reason = None
    flow.train_loss.extend(float(v) for v in tls)
    flow.valid_loss.extend(float(v) for v in vls)
    if skips is not None:
        flow.skipped_updates.extend(int(v) for v in skips)
        if verbose and skips.sum():
            print(f"[skipped {int(skips.sum())} non-finite updates]")
    if metrics_log is not None:
        _write_metrics(metrics_log, flow, epochs)
    out_state = _unfold_adam_state(folded, fstate)
    if verbose:
        for e, (tl, vl) in enumerate(zip(tls, vls)):
            print(f"epoch: {len(flow.train_loss) - epochs + e + 1} | "
                  f"train_loss = {tl}, valid_loss = {vl}")
        sps = epochs * xt.shape[0] / elapsed if elapsed > 0 else float("inf")
        print(f"[mesh fused-step kernel | {elapsed:.2f}s | {sps:,.0f} "
              f"samples/s]")
    if track_best:
        best_model = copy.deepcopy(flow.model)
        load_leaves_(best_model, folded.unfold(sp.unflatten(best_flat)))
        return out_state, best_model
    return out_state


# -- chunked loops ------------------------------------------------------------

def _chunk_seed(generator, mesh=None, device="cpu") -> int:
    """One draw of the caller's generator: the seed every chunk's generator
    is derived from (on a mesh rank 0's draw, broadcast through a tensor on
    ``device``, the flow's)."""
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    seed = torch.randint(0, 2**62, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    if mesh is not None:
        seed = mesh.broadcast_(seed.to(device)).cpu()
    return int(seed)


def _chunk_generator(seed: int, done: int) -> torch.Generator:
    """The generator of the chunk that starts after ``done`` epochs: a
    function of (seed, done) only, never of call order."""
    return torch.Generator().manual_seed(
        (seed + 0x9E3779B97F4A7C15 * (done + 1)) % (2**63 - 1))


def _chunk_perms(epoch_perms, done, chunk):
    return None if epoch_perms is None else \
        np.asarray(epoch_perms)[done:done + chunk]


def _shard_restored(mesh, model, opt_state):
    """A replicated chain and Adam state (a checkpoint's) placed
    tensor-parallel over ``mesh``'s ``model`` axis: each moment list is
    loaded into a copy of the chain and sharded with it."""
    from .parallel.mesh import shard_params_tp

    placed = shard_params_tp(mesh, model)
    if opt_state is None:
        return placed, None

    def shard(values):
        holder = copy.deepcopy(model)
        load_leaves_(holder, values)
        return [t.detach().clone() for t in
                trainable_leaves(shard_params_tp(mesh, holder))]

    return placed, AdamState(opt_state.count, shard(opt_state.mu),
                             shard(opt_state.nu))


def _train_with_checkpoints(
    flow, data, optimizer, opt_state, *, epochs, batchsize, shuffle, verbose,
    generator, debug, checkpoint_dir, checkpoint_every, resume,
    metrics_log=None, weights=None, skip_nonfinite=False, epoch_perms=None,
    mesh=None, remat=False, mixed_precision=False,
):
    """Chunked training with checkpoint-restart recovery: chunks of
    ``checkpoint_every`` epochs with a full checkpoint (model + optimizer
    state + histories) written between them."""
    from .utils.checkpoint import load_flow, save_flow

    # the chunk train() calls receive the USER's optimizer (None when
    # unspecified) so plain-surface chunks may route through the kernel
    seed = _chunk_seed(generator, mesh, flow.device)
    done = 0
    if resume and os.path.exists(os.path.join(checkpoint_dir, "flow.json")):
        restored = load_flow(checkpoint_dir,
                             optimizer if optimizer is not None else Adam(),
                             device=flow.device)
        if isinstance(restored, tuple):
            restored_flow, opt_state = restored
        else:
            restored_flow, opt_state = restored, None
        flow.model = restored_flow.model
        if mesh is not None and mesh.model_size > 1:
            # the checkpoint holds the replicated chain: place it again
            flow.model, opt_state = _shard_restored(mesh, flow.model,
                                                    opt_state)
        flow.train_loss[:] = restored_flow.train_loss
        flow.valid_loss[:] = restored_flow.valid_loss
        done = len(flow.train_loss)
        if verbose and done:
            print(f"[resumed from {checkpoint_dir} at epoch {done}]")

    target = max(epochs, done)
    # per-chunk generators derived from position so a resumed run replays
    # the exact shuffle sequence of an uninterrupted one
    while done < target:
        chunk = min(checkpoint_every, target - done)
        opt_state = train(
            flow, data, optimizer, opt_state, epochs=chunk,
            batchsize=batchsize, shuffle=shuffle, verbose=verbose,
            generator=_chunk_generator(seed, done), debug=debug,
            metrics_log=metrics_log, weights=weights,
            skip_nonfinite=skip_nonfinite, mesh=mesh, remat=remat,
            mixed_precision=mixed_precision,
            _epoch_perms=_chunk_perms(epoch_perms, done, chunk))
        done += chunk
        # every rank of a data axis holds the same model and state: data
        # rank 0 writes (with tensor-parallel shards, its model axis gathers
        # them and the axis's rank 0 writes)
        if mesh is None or mesh.rank == 0:
            save_flow(checkpoint_dir, flow, opt_state, erase=True)
        if mesh is not None:
            mesh.barrier()
    return opt_state


def _train_early_stopping(
    flow, data, optimizer, opt_state, *, epochs, batchsize, shuffle, verbose,
    generator, debug, patience, min_delta, check_every, restore_best,
    metrics_log, weights=None, skip_nonfinite=False, epoch_perms=None,
    mesh=None, remat=False, mixed_precision=False,
):
    """Chunked training with validation-based early stopping. Between chunks
    of ``check_every`` epochs the host inspects the validation-loss tail and
    stops once the best validation NLL has not improved by ``min_delta`` for
    ``patience`` consecutive epochs; with ``restore_best`` the model is
    rolled back to the EXACT best-epoch parameters (each chunk tracks its
    best epoch, so the restore is epoch-exact whatever ``check_every``)."""
    seed = _chunk_seed(generator, mesh, flow.device)
    best = float("inf")
    best_restore = float("inf")
    best_model = None
    best_epoch = 0
    done = 0
    while done < epochs:
        chunk = min(check_every, epochs - done)
        res = train(
            flow, data, optimizer, opt_state, epochs=chunk,
            batchsize=batchsize, shuffle=shuffle, verbose=verbose,
            generator=_chunk_generator(seed, done), debug=debug,
            metrics_log=metrics_log, weights=weights,
            skip_nonfinite=skip_nonfinite, _track_best=restore_best,
            mesh=mesh, remat=remat, mixed_precision=mixed_precision,
            _epoch_perms=_chunk_perms(epoch_perms, done, chunk))
        opt_state, chunk_best = res if restore_best else (res, None)
        done += chunk
        tail = flow.valid_loss[-chunk:]
        if restore_best and min(tail) < best_restore:
            # chunk_best is the model at the chunk's argmin epoch
            best_restore = min(tail)
            best_model = chunk_best
        if min(tail) < best - min_delta:
            i_rel = int(np.argmin(tail))
            best = tail[i_rel]
            best_epoch = done - chunk + i_rel + 1
        no_improve_for = done - best_epoch
        if no_improve_for >= patience:
            if verbose:
                print(f"[early stop at epoch {done}: no valid improvement "
                      f"> {min_delta} for {no_improve_for} epochs; best "
                      f"{best:.6f} @ epoch {best_epoch}]")
            break
    if restore_best and best_model is not None:
        flow.model = best_model
    return opt_state


def evaluate(flow: Flow, data: DataArrays, split: str = "testing") -> float:
    """Full-split NLL on ``'training'`` / ``'validation'`` / ``'testing'``."""
    getter = {
        "training": data.normalized_training_data,
        "validation": data.normalized_validation_data,
    }.get(split)
    if getter is not None:
        x, th = getter(flow.metadata)
    elif split == "testing":
        x, th = data.testing_data()
        th = normalize_input(th, flow.metadata.theta_min,
                             flow.metadata.theta_max)
    else:
        raise ValueError(f"unknown split {split!r}")
    if x.shape[0] == 0:
        raise ValueError(f"split {split!r} is empty")
    return float(_eval_nll(flow.model, flow.base, _put(x, flow.device),
                           _put(th, flow.device)))


def batch_iterator(
    x: np.ndarray,
    theta: np.ndarray,
    batchsize: int,
    *,
    shuffle: bool = True,
    rng: np.random.Generator | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Host-side batcher for callers of :func:`make_train_step`: yields
    (x_batch, theta_batch, mask) with fixed shapes; the final partial batch
    is padded with row 0 and masked."""
    n = x.shape[0]
    if rng is None:
        rng = np.random.default_rng()
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batchsize):
        idx = order[start:start + batchsize]
        k = len(idx)
        mask = np.zeros((batchsize,), np.float32)
        mask[:k] = 1.0
        if k < batchsize:
            idx = np.concatenate([idx, np.zeros((batchsize - k,), idx.dtype)])
        yield x[idx], theta[idx], mask


def _in_train_span(fn):
    """``train`` inside its ``df.train`` span, the root of the call's stage
    spans (``utils/spans.py``)."""

    @functools.wraps(fn)
    def train(*args, **kwargs):
        with span("df.train"):
            return fn(*args, **kwargs)

    return train


_DEBUG_CHUNK = 10
_PLAIN = "torch"   # flow.trained_path of the plain program


@_in_train_span
def train(
    flow: Flow,
    data: DataArrays,
    optimizer=None,
    opt_state=None,
    *,
    epochs: int = 100,
    batchsize: int = 64,
    shuffle: bool = True,
    verbose: bool = True,
    generator=None,
    mesh=None,
    debug: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 10,
    resume: bool = False,
    metrics_log: str | None = None,
    early_stopping_patience: int | None = None,
    early_stopping_min_delta: float = 0.0,
    early_stopping_check_every: int | None = None,
    restore_best: bool = True,
    remat: bool = False,
    mixed_precision: bool = False,
    weights=None,
    skip_nonfinite: bool = False,
    fused_kernel: bool | str = "auto",
    _track_best: bool = False,
    _epoch_perms=None,
):
    """Train the flow by NLL, on the flow's device.

    Defaults: epochs=100, batchsize=64, shuffle=True, Adam(1e-3). θ is
    normalized once through the flow's metadata. ``generator``: the
    ``torch.Generator`` the per-epoch shuffles are drawn from (None: a fresh
    non-deterministic one).

    Fault tolerance: with ``checkpoint_dir`` set, the run is chunked into
    ``checkpoint_every`` epochs with a full checkpoint (model + optimizer
    state + histories) written between chunks; ``resume=True`` restarts from
    the last checkpoint, skipping the epochs already done.

    Early stopping: ``early_stopping_patience=p`` stops once the validation
    NLL has not improved by ``early_stopping_min_delta`` for ``p`` epochs
    (checked every ``early_stopping_check_every`` epochs, default
    ``min(p, 10)``); ``restore_best`` rolls the model back to the exact
    best-validation epoch's parameters.

    ``weights``: per-row importance weights aligned with the RAW ``data``
    rows — batch losses and both per-epoch full-split evaluations become the
    weighted NLL −Σwᵢ·log pᵢ / Σwᵢ.

    ``skip_nonfinite=True``: each batch update is applied only when the loss
    and all gradients are finite; skipped steps leave the state untouched and
    are counted in ``flow.skipped_updates`` (one entry per epoch).
    ``debug=True`` chunks the run into 10-epoch pieces so a non-finite epoch
    loss raises ``FloatingPointError`` within about 10 epochs.

    Returns ``opt_state`` so training can be continued exactly.

    ``fused_kernel`` selects the whole-run kernels (``models/fused_train.py``):
    every epoch in ONE launch of ``train_run``, with the parameters and Adam
    moments in one block's shared memory, or — for a model too large for
    that — one launch of ``train_stream`` per chunk of epochs, with them in
    device memory (``flow.fused_kernel_mode`` is ``"resident"`` or
    ``"stream"``; ``flow.trained_path`` is ``"fused"`` for both). Supported
    surface: RNVP / joint / NICE couplings (incl. ``max_log_scale`` clamps)
    + ActNorm / Normalization / Permutation layers, StandardNormal base,
    Adam (the default or ``adam(lr, b1, b2, eps)``), ``weights=``,
    ``skip_nonfinite``, ``metrics_log`` and best-epoch tracking. Same batch
    order as the plain program (losses agree to float accumulation order);
    the returned state continues on either path.

    - ``"auto"`` (default): route through the kernels when the flow is on a
      CUDA device, the call is on the plain training surface and the
      chain/config is inside an envelope (the resident one first, then the
      streaming one); otherwise run the plain program. Every decline is
      recorded in ``flow.fused_decline_reason`` (and printed with
      ``verbose``); a chain or config outside both envelopes on a CUDA flow
      also raises a ``RuntimeWarning``. A CPU flow never auto-routes.
    - ``True``: force the kernel path (on a CPU flow: the kernels' plain
      versions, the streaming one where the resident budget fails); raises
      ``ValueError`` / ``UnsupportedFusedTrain`` outside the supported
      surface.
    - ``False``: always the plain program.

    ``mesh`` (``parallel.mesh.make_mesh()``): data-parallel training over
    the ranks of a ``torch.distributed`` group. Every rank calls ``train``
    with the same data, model and ``generator`` seed (rank 0's permutations
    and parameters are broadcast), works on its rows of every batch, and ends
    with the same model, histories and state. The whole-run kernel has no
    mesh mode; under ``"auto"`` a CUDA flow with an ``adam(...)`` optimizer
    inside the step kernel's envelope takes the step-kernel program
    (``flow.trained_path == "fused-step-mesh"``), any other run the plain
    program with an all-reduce of the autograd gradients, with the decline
    recorded and, on a CUDA flow, warned about. ``fused_kernel=True`` with a
    mesh forces the step-kernel program (on a CPU flow: the kernel's plain
    version) or raises.

    ``remat`` / ``mixed_precision`` (see :func:`masked_nll_loss`) are
    options of the plain program: under ``"auto"`` such a run takes it with
    the decline recorded ("off-kernel training surface"); with
    ``fused_kernel=True`` they raise ``ValueError``.

    ``flow.trained_path`` is ``"fused"``, ``"fused-step-mesh"`` or
    ``"torch"`` after the call. A kernel that fails to build or launch
    raises; nothing turns such a failure into a run on the other path.
    """
    check_mesh(mesh)
    if has_batch_norm(flow.model) and (mesh is not None or remat):
        raise ValueError(
            "a model with batch norm trains on one device without remat: "
            "each rank would normalise by its shard's statistics, and a "
            "recomputed forward would move the running statistics twice")
    requested = fused_kernel
    # Adam hyperparameters the kernel can honor: None → Adam(1e-3); an
    # adam(...) → its lr/b1/b2/eps. Exact-type check: an Adam SUBCLASS may
    # override update() with semantics the kernel does not implement
    kernel_hp = {}
    if type(optimizer) is Adam:
        kernel_hp = dict(lr=optimizer.learning_rate, b1=optimizer.b1,
                         b2=optimizer.b2, eps=optimizer.eps)

    def fused_call():
        out = train_fused(
            flow, data, epochs=epochs, batchsize=batchsize, shuffle=shuffle,
            verbose=verbose, generator=generator, opt_state=opt_state,
            track_best=_track_best, weights=weights,
            skip_nonfinite=skip_nonfinite, _epoch_perms=_epoch_perms,
            **kernel_hp)
        flow.trained_path = "fused"
        flow.fused_decline_reason = None
        if metrics_log is not None:
            _write_metrics(metrics_log, flow, epochs)
        return out

    def note_decline(reason, warn=False):
        flow.fused_decline_reason = reason
        if warn:
            warnings.warn(
                f"train: the whole-run kernel declined this run ({reason}); "
                "the plain program trains it, one launch per operation. Pass "
                "fused_kernel=False to choose that path without this warning",
                RuntimeWarning, stacklevel=3)
        if verbose:
            print(f"[fused-train kernel not used — {reason}; using the "
                  f"plain program]")

    if fused_kernel == "auto":
        chunked_loop = (early_stopping_patience is not None
                          or checkpoint_dir is not None)
        blocked = [name for name, flag in (
            ("mesh", mesh is not None),
            ("debug", debug),
            ("remat", remat),
            ("mixed_precision", mixed_precision),
            ("optimizer other than adam(...)",
             optimizer is not None and type(optimizer) is not Adam),
        ) if flag]
        if flow.device.type != "cuda":
            # recorded but not printed: there is no kernel to lose here
            flow.fused_decline_reason = f"non-CUDA device ({flow.device.type})"
        elif chunked_loop:
            pass  # the chunk loop's inner train() calls decide per chunk
        elif blocked:
            note_decline("off-kernel training surface: " + ", ".join(blocked))
        else:
            try:
                return fused_call()
            except UnsupportedFusedTrain as e:
                # outside the envelope — the plain program handles it, and
                # the caller, who did not choose that, is told
                note_decline(f"outside the kernel envelope: {e}", warn=True)
        fused_kernel = False
    if fused_kernel:
        if (remat or mixed_precision or debug or checkpoint_dir is not None
                or early_stopping_patience is not None):
            raise ValueError(
                "fused_kernel=True supports the plain training surface only "
                "(no remat/mixed_precision/debug/checkpointing/early "
                "stopping) — drop fused_kernel to use the plain program")
        if optimizer is not None and type(optimizer) is not Adam:
            raise ValueError(
                "fused_kernel=True uses the built-in Adam update; pass an "
                "adam(lr, b1, b2, eps) (its hyperparameters are "
                "introspectable) instead of another optimizer or an Adam "
                "subclass")
        if mesh is None:
            return fused_call()
        # on a mesh the forced kernel path is the step-kernel program below
    if early_stopping_patience is not None:
        if checkpoint_dir is not None:
            raise ValueError(
                "early stopping and checkpoint_dir are separate chunked "
                "loops — use one or the other")
        return _train_early_stopping(
            flow, data, optimizer, opt_state, epochs=epochs,
            batchsize=batchsize, shuffle=shuffle, verbose=verbose,
            generator=generator, debug=debug,
            patience=early_stopping_patience,
            min_delta=early_stopping_min_delta,
            check_every=(early_stopping_check_every
                         or min(early_stopping_patience, 10)),
            restore_best=restore_best, metrics_log=metrics_log,
            weights=weights, skip_nonfinite=skip_nonfinite,
            epoch_perms=_epoch_perms, mesh=mesh, remat=remat,
            mixed_precision=mixed_precision)
    if checkpoint_dir is not None:
        return _train_with_checkpoints(
            flow, data, optimizer, opt_state, epochs=epochs,
            batchsize=batchsize, shuffle=shuffle, verbose=verbose,
            generator=generator, debug=debug, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            metrics_log=metrics_log, weights=weights,
            skip_nonfinite=skip_nonfinite, epoch_perms=_epoch_perms,
            mesh=mesh, remat=remat, mixed_precision=mixed_precision)
    if optimizer is None:
        optimizer = Adam()

    if debug and epochs > _DEBUG_CHUNK and not _track_best:
        # chunked execution so a non-finite epoch loss raises within about
        # _DEBUG_CHUNK epochs, not after the whole run
        seed = _chunk_seed(generator, mesh, flow.device)
        done = 0
        while done < epochs:
            chunk = min(_DEBUG_CHUNK, epochs - done)
            opt_state = train(
                flow, data, optimizer, opt_state, epochs=chunk,
                batchsize=batchsize, shuffle=shuffle, verbose=verbose,
                generator=_chunk_generator(seed, done), debug=True,
                metrics_log=metrics_log, weights=weights,
                skip_nonfinite=skip_nonfinite, fused_kernel=False, mesh=mesh,
                remat=remat, mixed_precision=mixed_precision,
                _epoch_perms=_chunk_perms(_epoch_perms, done, chunk))
            done += chunk
        return opt_state

    dev = flow.device
    xt, tht, xv, thv, w_train, w_valid = data.normalized_splits_on(
        flow.metadata, dev, weights)
    n_train = xt.shape[0]
    model = flow.model

    if mesh is not None:
        # one batch order for every rank: rank 0's
        n_rows = xt.shape[0]
        perms = (draw_epoch_perms(generator, epochs, n_rows, shuffle)
                 if _epoch_perms is None else np.asarray(_epoch_perms))
        perms_t = torch.as_tensor(np.ascontiguousarray(perms, np.int64))
        _epoch_perms = mesh.broadcast_(perms_t.to(dev)).cpu().numpy()

        # the step-kernel program: forced, or by default on a CUDA flow
        # inside the kernel's envelope (Adam only: the folded state needs
        # its moments). A mesh with a 'model' axis is always declined: the
        # kernel holds whole networks and shards 'data' only
        forced = requested is True
        wanted = forced or (requested == "auto" and dev.type == "cuda"
                            and not (debug or remat or mixed_precision))
        reason = None
        if mesh.model_size > 1 or (wanted and type(optimizer) is Adam):
            try:
                folded = fold_for_step_mesh(flow, batchsize, mesh)
                if opt_state is not None \
                        and not isinstance(opt_state, AdamState):
                    raise UnsupportedFusedTrain(
                        "opt_state is not an Adam state (need count, mu, nu)")
            except UnsupportedFusedTrain as e:
                reason = str(e)
            else:
                hp = _adam_hp(optimizer.learning_rate, optimizer.b1,
                              optimizer.b2, optimizer.eps)
                return _run_fused_step_mesh(
                    flow, mesh, folded, batchsize, epochs, shuffle,
                    generator, xt, tht, xv, thv, w_train, w_valid, hp,
                    opt_state, _track_best, skip_nonfinite, verbose,
                    metrics_log, _epoch_perms)
        if reason is not None:
            if forced:
                raise UnsupportedFusedTrain(reason)
            flow.fused_decline_reason = f"mesh fused-step not used — {reason}"
            if wanted:
                warnings.warn(
                    f"train: the step kernel declined this data-parallel run "
                    f"({reason}); the plain program trains it with an "
                    "all-reduce of the autograd gradients. Pass "
                    "fused_kernel=False to choose that path without this "
                    "warning", RuntimeWarning, stacklevel=2)
            if verbose:
                print(f"[mesh fused-step kernel not used — {reason}; using "
                      f"the plain data-parallel program]")
        # rank 0's parameters on every rank of each data axis (a shard
        # sharded over 'model' keeps its shard)
        from .parallel.mesh import put_replicated

        put_replicated(mesh, [p.data for p in trainable_leaves(model)
                              if p.numel()])

    if opt_state is None:
        opt_state = optimizer.init(trainable_leaves(model))

    graphed = (xt.is_cuda and mesh is None and not remat
               and not mixed_precision and not skip_nonfinite
               and _graph_reason(model, flow.base, optimizer) is None)
    program = make_train_program(
        optimizer, batchsize, epochs, shuffle, remat=remat,
        mixed_precision=mixed_precision, weighted=weights is not None,
        track_best=_track_best, guard_nonfinite=skip_nonfinite, mesh=mesh,
        graphed=graphed)
    t0 = time.perf_counter()
    if weights is not None:
        out = program(model, opt_state, flow.base, xt, tht, w_train, xv, thv,
                      w_valid, generator, epoch_perms=_epoch_perms)
    else:
        out = program(model, opt_state, flow.base, xt, tht, xv, thv,
                      generator, epoch_perms=_epoch_perms)
    model, opt_state, tls, vls = out[:4]
    rest = list(out[4:])
    best_model = rest.pop(0) if _track_best else None
    skips = rest.pop(0) if skip_nonfinite else None
    elapsed = time.perf_counter() - t0
    flow.model = model
    flow.trained_path = _PLAIN
    flow.train_loss.extend(float(v) for v in tls)
    flow.valid_loss.extend(float(v) for v in vls)
    if skips is not None:
        flow.skipped_updates.extend(int(v) for v in skips)
        if verbose and skips.sum():
            print(f"[skipped {int(skips.sum())} non-finite updates]")

    if metrics_log is not None:
        _write_metrics(metrics_log, flow, epochs)

    if debug and (not np.all(np.isfinite(tls)) or not np.all(np.isfinite(vls))):
        raise FloatingPointError(
            "non-finite epoch loss encountered "
            f"(train={tls.tolist()}, valid={vls.tolist()})")
    if verbose:
        for e, (tl, vl) in enumerate(zip(tls, vls)):
            print(f"epoch: {len(flow.train_loss) - epochs + e + 1} | "
                  f"train_loss = {tl}, valid_loss = {vl}")
        sps = epochs * n_train / elapsed if elapsed > 0 else float("inf")
        print(f"[{elapsed:.2f}s | {sps:,.0f} samples/s]")
    if _track_best:
        return opt_state, best_model
    return opt_state
