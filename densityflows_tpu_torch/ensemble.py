"""Deep-ensemble flows: K members of one structure, trained together.

PyTorch counterpart of ``densityflows_tpu/ensemble.py``. The JAX package
trains the K members as one program, a ``jax.vmap`` of its training program
over a leading member axis. Here the member axis is an axis of the whole-run
kernel: on a CUDA device an ensemble inside ``train_run``'s envelope trains
in ONE launch of K blocks, block k training member k exactly as a launch of
its own would (``ops/train_kernels.py::run_fused_train_members``). Outside
the envelope (another optimizer, a layer the kernel does not cover, a
``mesh``) and on the CPU, the members run the plain training program as one
program over the member axis (``torch.func.vmap`` of its loss's gradients,
as JAX vmaps), the decline recorded on the members as ``train()`` records
it. Members see the
same data but their own initial parameters and their own shuffles (the
deep-ensembles recipe, Lakshminarayanan et al. 2017).

The result, :class:`EnsembleFlow`, is a uniform mixture:
``log_prob = logsumexp_k log p_k(x|θ) − log K``; the spread across
``log_prob_members`` is the epistemic-uncertainty signal. On CUDA each
member's fold is one ``chain_apply`` launch (``models/flow.py::_chain_eval``).

Randomness is an explicit ``torch.Generator``: the members' initial and
training generators are derived from two draws of the caller's generator and
the member's position, as ``train()``'s chunked loops derive theirs.
"""

from __future__ import annotations

import json
import math
import time
import warnings

import numpy as np
import torch

from ._device import resolve_device
from .data import DataArrays
from .models.flow import Flow, _chain_eval
from .utils.checkpoint import element_leaves, element_spec

__all__ = ["EnsembleFlow", "StackedModels", "train_ensemble", "stack_models"]


class StackedModels:
    """K models of one static structure, the ensemble's member axis.

    The members are modules of their own (member ``i`` is ``self[i]``);
    :meth:`leaves` gives the arrays of the JAX package's stacked pytree:
    every leaf of ``element_leaves`` order with a leading K axis."""

    def __init__(self, members):
        self.members = list(members)

    def __len__(self) -> int:
        return len(self.members)

    def __getitem__(self, i):
        return self.members[i]

    def __iter__(self):
        return iter(self.members)

    def leaves(self) -> list[torch.Tensor]:
        """``(K, ...)`` tensors, one per leaf in ``element_leaves`` order."""
        per_member = [element_leaves(m) for m in self.members]
        return [torch.stack([t.detach() for t in ts])
                for ts in zip(*per_member)]


def stack_models(models) -> StackedModels:
    """Stack identically structured models along a new member axis. All
    members must share their static structure (layer types, axes and masks,
    activations, widths, ``InvertibleLinearLayer.perm``): built by the same
    factory with different generators."""
    models = list(models)
    if len(models) < 1:
        raise ValueError("need at least one model")
    specs = {json.dumps(element_spec(m), sort_keys=True) for m in models}
    if len(specs) != 1:
        raise ValueError(
            "ensemble members must share one structure (same factory, "
            "different generators). Note layers whose STATIC structure is "
            "random (e.g. invertible_linear_layer's LU pivots, a random "
            "permutation_layer) must be built from one shared generator "
            "across members — vary only the conditioner generators.")
    return StackedModels(models)


class EnsembleFlow:
    """Uniform mixture of K flows sharing one base and θ-metadata.

    ``model`` holds the members (:class:`StackedModels`); ``train_loss`` /
    ``valid_loss`` are ``(epochs, K)`` lists of per-member histories.
    ``trained_path`` / ``fused_decline_reason`` / ``fused_kernel_mode`` are
    per-member lists after :func:`train_ensemble` (None before)."""

    def __init__(self, stacked_model, metadata, base, n_members: int,
                 train_loss=None, valid_loss=None, *, device=None):
        if not isinstance(stacked_model, StackedModels):
            stacked_model = stack_models(stacked_model)
        if len(stacked_model) != int(n_members):
            raise ValueError(f"n_members is {n_members}, the stacked model "
                             f"holds {len(stacked_model)}")
        self.device = resolve_device(device)
        self.n_members = int(n_members)
        self._flows = [Flow(m, metadata, base, device=self.device)
                       for m in stacked_model]
        self.model = StackedModels([f.model for f in self._flows])
        self.metadata = metadata
        self.base = self._flows[0].base
        self.train_loss = [list(r) for r in train_loss] if train_loss else []
        self.valid_loss = [list(r) for r in valid_loss] if valid_loss else []
        self.trained_path = [None] * self.n_members
        self.fused_decline_reason = [None] * self.n_members
        self.fused_kernel_mode = [None] * self.n_members

    def member(self, i: int) -> Flow:
        """Member ``i`` as a standalone :class:`Flow` (it shares the member's
        module), carrying its own loss history and training record."""
        f = Flow(self.model[i], self.metadata, self.base, device=self.device)
        f.train_loss = [float(row[i]) for row in self.train_loss]
        f.valid_loss = [float(row[i]) for row in self.valid_loss]
        f.trained_path = self.trained_path[i]
        f.fused_decline_reason = self.fused_decline_reason[i]
        f.fused_kernel_mode = self.fused_kernel_mode[i]
        return f

    def _as_x(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def log_prob_members(self, x, theta=None):
        """``(K, batch...)`` per-member log densities; on CUDA one
        ``chain_apply`` launch per member."""
        x = self._as_x(x)
        theta_n = self._flows[0].prepare_theta(theta, x.shape[:-1])
        out = []
        with torch.no_grad():
            for f in self._flows:
                z, ldj = _chain_eval(f.model, x, theta_n, "inv")
                out.append(self.base.log_prob(z) + ldj)
        return torch.stack(out)

    def log_prob(self, x, theta=None):
        """Mixture log density: logsumexp over the members − log K."""
        lp = self.log_prob_members(x, theta)
        return torch.logsumexp(lp, 0) - math.log(self.n_members)

    def prob(self, x, theta=None):
        return torch.exp(self.log_prob(x, theta))

    def sample(self, dims, theta=None, *, generator=None, _draws=None):
        """Stratified mixture sampling: ⌈n/K⌉ base draws per member (one
        ``(K, per, d)`` draw), each member's forward fold, then a random
        interleaving of the flattened rows truncated to ``prod(dims)``. The
        base draw and the permutation come from ``generator`` in that order
        (``_draws``: a source of both in place of the generator, for tests
        that replay another program's draws)."""
        from .inference import _Draws

        dims = (dims,) if isinstance(dims, int) else tuple(int(s)
                                                           for s in dims)
        n = int(np.prod(dims)) if dims else 1
        k = self.n_members
        per = -(-n // k)
        draws = _draws if _draws is not None else _Draws(generator,
                                                         self.device)
        theta_n = self._flows[0].prepare_theta(theta, (per,))
        r = draws.base(self.base, (k, per)).to(self.device)
        with torch.no_grad():
            ys = [_chain_eval(f.model, r[i], theta_n, "fwd")[0]
                  for i, f in enumerate(self._flows)]
        flat = torch.stack(ys).reshape(k * per, -1)
        take = draws.permutation(k * per).to(self.device)[:n]
        return flat[take].reshape(dims + (flat.shape[-1],))

    def summarize(self) -> str:
        return (f"EnsembleFlow | {self.n_members} members\n"
                + self.model[0].summarize())


# -- training -------------------------------------------------------------------

def _member_generators(seed, k):
    from .train import _chunk_generator

    return [_chunk_generator(seed, i) for i in range(k)]


def _kernel_members(flows, batchsize):
    """Fold every member for ``train_run``; the plan, the gradient masks and
    the constants must be the same for all (one plan, one launch). Returns
    ``(folds, packed)`` or raises ``UnsupportedFusedTrain``."""
    from .models.distributions import StandardNormal
    from .models.fused_train import (
        UnsupportedFusedTrain, _check_budget, chain_train_fold)
    from .ops.train_kernels import pack_train_plan

    if not isinstance(flows[0].base, StandardNormal):
        raise UnsupportedFusedTrain("fused train supports the "
                                    "StandardNormal base only")
    folds = [chain_train_fold(f.model) for f in flows]
    plan, _, tparams, masks, slots, cparams = folds[0][:6]
    for other in folds[1:]:
        if other[0] != plan or other[4] != slots:
            raise UnsupportedFusedTrain("the members fold to different plans")
        if any(not torch.equal(a, b) for a, b in zip(other[3], masks)) or \
                any(not torch.equal(a, b) for a, b in zip(other[5], cparams)):
            raise UnsupportedFusedTrain(
                "the members' constants (normalization ranges) differ; one "
                "launch shares them")
    m = flows[0].metadata
    packed = pack_train_plan(plan, tparams, masks, slots, cparams, m.d, m.n,
                             batchsize)
    _check_budget(packed)
    return folds, packed


def _train_members_kernel(flows, folds, packed, arrays, perms, batchsize,
                          hp):
    """Every member in one ``train_run`` launch of K blocks; the members'
    models are updated in place. Returns the ``(K, epochs)`` histories."""
    from .models.fused_train import load_leaves_
    from .ops.train_kernels import run_fused_train_members

    plan, _, _, masks, slots, cparams = folds[0][:6]
    tparams = [f[2] for f in folds]
    zeros = [[torch.zeros_like(p) for p in tp] for tp in tparams]
    out = run_fused_train_members(
        plan, tparams, masks, slots, cparams, zeros, zeros, *arrays,
        list(perms), batchsize=batchsize, packed=packed, **hp)
    tls, vls = [], []
    for flow, fold, res in zip(flows, folds, out):
        load_leaves_(flow.model, fold[7](res[0]))
        tls.append(res[3].cpu().numpy())
        vls.append(res[4].cpu().numpy())
    return np.stack(tls), np.stack(vls)


class _MemberLoss(torch.nn.Module):
    """The plain program's batch loss as a module call, for
    ``torch.func.functional_call`` on one member's parameters."""

    def __init__(self, model, base):
        super().__init__()
        self.model = model
        self.base = base

    def forward(self, x, theta, mask):
        from .train import masked_nll_loss

        return masked_nll_loss(self.model, self.base, x, theta, mask)


def _one_program(flows) -> bool:
    """Whether the members can train as one vmapped program: it takes every
    non-trainable leaf (masks, pivots, normalization ranges) from member 0,
    so these must be equal, and the per-layer coupling kernels
    (``set_fused_kernels(True)``) must be off, as their autograd functions
    have no batching rule; a model with batch norm trains member by member
    (its batch statistics move buffers in place)."""
    from .models.layers import use_fused
    from .ops.mlp import has_batch_norm

    if use_fused(0) or any(has_batch_norm(f.model) for f in flows):
        return False
    fixed = [[t for t in element_leaves(f.model)
              if not isinstance(t, torch.nn.Parameter)] for f in flows]
    return all(len(c) == len(fixed[0])
               and all(torch.equal(a, b) for a, b in zip(fixed[0], c))
               for c in fixed[1:])


def _train_members_vmapped(flows, optimizer, arrays, perms, batchsize,
                           epochs, shuffle):
    """Every member on the plain training program at once, as the JAX
    package vmaps its program: per batch ONE ``torch.func.vmap`` of the
    loss over the members' stacked parameters (member k on its own rows)
    and one backward pass of the members' summed losses, which gives each
    member its own gradients; then one optimizer update of the stacked
    leaves (``Adam`` is elementwise, so that is each member's own update),
    or each member's update for another optimizer. Each epoch's full-split
    NLLs are taken member by member. The members' models are updated in
    place. Returns the ``(K, epochs)`` histories."""
    from torch.func import functional_call, vmap

    from .models.fused_train import load_leaves_, trainable_leaves
    from .train import Adam, _batch_order

    x, th, xv, thv = arrays
    loss_mod = _MemberLoss(flows[0].model, flows[0].base)
    names = {id(p): n for n, p in loss_mod.named_parameters()}
    keys = [names[id(p)] for p in trainable_leaves(loss_mod.model)]
    leaves = [trainable_leaves(f.model) for f in flows]
    stacked = [torch.stack([ls[j].detach() for ls in leaves]).requires_grad_()
               for j in range(len(keys))]
    one_update = type(optimizer) is Adam
    states = ([optimizer.init(stacked)] if one_update
              else [optimizer.init(ls) for ls in leaves])

    def loss(params, xb, thb, m):
        return functional_call(loss_mod, dict(zip(keys, params)),
                               (xb, thb, m))

    losses_of = vmap(loss, in_dims=(0, 0, 0, None))
    orders = [_batch_order(x, batchsize, epochs, shuffle, None, p)
              for p in perms]
    n_batches, pad_mask = orders[0][0], orders[0][2]
    idx = torch.stack([o[1] for o in orders])          # (K, epochs, n_pad)
    ones_t, ones_v = x.new_ones(x.shape[0]), x.new_ones(xv.shape[0])
    tls, vls = [], []
    for e in range(epochs):
        for b in range(n_batches):
            sl = slice(b * batchsize, (b + 1) * batchsize)
            rows = idx[:, e, sl]
            with torch.enable_grad():
                grads = torch.autograd.grad(
                    losses_of(stacked, x[rows], th[rows], pad_mask[sl]).sum(),
                    stacked, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                if one_update:
                    updates, states[0] = optimizer.update(grads, states[0],
                                                          stacked)
                else:
                    per = []
                    for i, state in enumerate(states):
                        u, states[i] = optimizer.update(
                            [g[i] for g in grads], state,
                            [p[i] for p in stacked])
                        per.append(u)
                    updates = [torch.stack(u) for u in zip(*per)]
                torch._foreach_add_(stacked, list(updates))
        with torch.no_grad():
            views = [[p[i] for p in stacked] for i in range(len(flows))]
            tls.append(torch.stack([loss(v, x, th, ones_t) for v in views]))
            vls.append(torch.stack([loss(v, xv, thv, ones_v)
                                    for v in views]))
    for i, flow in enumerate(flows):
        load_leaves_(flow.model, [p[i].detach() for p in stacked])
    return (torch.stack(tls, 1).cpu().numpy(),
            torch.stack(vls, 1).cpu().numpy())


def _train_members_plain(flows, optimizer, arrays, perms, batchsize, epochs,
                         shuffle):
    """Every member on the plain training program, one after another (the
    members :func:`_one_program` cannot take)."""
    from .models.fused_train import trainable_leaves
    from .train import make_train_program

    program = make_train_program(optimizer, batchsize, epochs, shuffle)
    x, th, xv, thv = arrays
    tls, vls = [], []
    for flow, perm in zip(flows, perms):
        state = optimizer.init(trainable_leaves(flow.model))
        _, _, tl, vl = program(flow.model, state, flow.base, x, th, xv, thv,
                               None, epoch_perms=perm)
        tls.append(tl)
        vls.append(vl)
    return np.stack(tls), np.stack(vls)


def _gather_members(mesh, flows, mine, tls, vls, k):
    """Every rank's members and histories on every rank: one all-gather of
    each rank's flat parameters and histories."""
    import torch.distributed as dist

    from .models.fused_train import load_leaves_, trainable_leaves

    dev = flows[0].device
    rows = [torch.cat([p.detach().reshape(-1)
                       for p in trainable_leaves(flows[i].model)]
                      + [torch.as_tensor(tls[j]).to(dev),
                         torch.as_tensor(vls[j]).to(dev)])
            for j, i in enumerate(mine)]
    local = torch.stack(rows)
    if mesh.group is None:
        gathered = local
    else:
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(parts, local, group=mesh.group)
        gathered = torch.cat(parts)
    epochs = tls.shape[1]
    for i, flow in enumerate(flows):
        leaves = trainable_leaves(flow.model)
        flat = gathered[i]
        vals, o = [], 0
        for p in leaves:
            vals.append(flat[o:o + p.numel()].reshape(p.shape))
            o += p.numel()
        load_leaves_(flow.model, vals)
    hist = gathered[:, -2 * epochs:].cpu().numpy()
    return hist[:, :epochs], hist[:, epochs:]


def train_ensemble(
    factory,
    data: DataArrays,
    *,
    n_members: int = 5,
    optimizer=None,
    epochs: int = 100,
    batchsize: int = 64,
    shuffle: bool = True,
    generator=None,
    base=None,
    verbose: bool = True,
    mesh=None,
    device=None,
    _epoch_perms=None,
) -> EnsembleFlow:
    """Build and train K flows of one structure.

    ``factory(generator) -> model chain`` builds one member (its own initial
    parameters); all members must share their static structure. Returns an
    :class:`EnsembleFlow` with per-member loss histories.

    On a CUDA device, with the default optimizer or an exact ``adam(...)``,
    a chain inside ``train_run``'s envelope and no ``mesh``, the whole
    ensemble is ONE ``train_run`` launch of K blocks (``trained_path``
    ``"fused"`` on every member). Otherwise the members run the plain
    training program, vmapped over the member axis; the reason is recorded per member in
    ``fused_decline_reason`` (and printed with ``verbose``; a chain outside
    the envelope on a CUDA device also warns). A CPU ensemble always runs
    the plain program.

    ``mesh`` (``parallel.mesh.make_mesh()``): shard the MEMBER axis over the
    ranks — members are independent, so each rank trains its
    ``n_members / world`` members with no collective, and the parameters
    and histories are all-gathered at the end. ``n_members`` must be a
    multiple of the mesh size. Every rank passes the same ``generator``
    seed (rank 0's draws are broadcast).

    ``_epoch_perms`` (``(K, epochs, n)``) replaces the batch orders drawn
    from the members' generators (tests inject another program's orders).
    """
    from .models.fused_train import UnsupportedFusedTrain, draw_epoch_perms
    from .parallel.mesh import check_mesh
    from .train import Adam, _chunk_seed, _put

    check_mesh(mesh)
    device = resolve_device(device)
    k = int(n_members)
    if k < 1:
        raise ValueError("n_members must be at least 1")
    if mesh is not None and k % mesh.size:
        raise ValueError(
            f"n_members ({k}) must be a multiple of the mesh data axis "
            f"({mesh.size}) to shard the member axis")
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    init_seed = _chunk_seed(generator, mesh, device)
    train_seed = _chunk_seed(generator, mesh, device)

    members = [factory(g) for g in _member_generators(init_seed, k)]
    stacked = stack_models(members)
    metadata = data.metadata()
    flows = [Flow(m, metadata, base, device=device) for m in stacked]

    x_train, th_train = data.normalized_training_data(metadata)
    x_valid, th_valid = data.normalized_validation_data(metadata)
    n = x_train.shape[0]
    arrays = (_put(x_train, device), _put(th_train, device),
              _put(x_valid, device), _put(th_valid, device))
    if _epoch_perms is not None:
        perms = np.asarray(_epoch_perms)
        if perms.shape != (k, epochs, n):
            raise ValueError(f"_epoch_perms must have shape {(k, epochs, n)}, "
                             f"got {perms.shape}")
    else:
        perms = np.stack([draw_epoch_perms(g, epochs, n, shuffle)
                          for g in _member_generators(train_seed, k)])

    mine = list(range(k))
    if mesh is not None:
        per = k // mesh.size
        mine = list(range(mesh.rank * per, (mesh.rank + 1) * per))

    # the route: one launch of K blocks, or the plain program per member
    reason, warn, folds = None, False, None
    if device.type != "cuda":
        reason = f"non-CUDA device ({device.type})"
    elif mesh is not None or (optimizer is not None
                              and type(optimizer) is not Adam):
        reason = "off-kernel training surface: " + ", ".join(
            name for name, flag in (
                ("mesh", mesh is not None),
                ("optimizer other than adam(...)",
                 optimizer is not None and type(optimizer) is not Adam))
            if flag)
    else:
        try:
            folds, packed = _kernel_members(flows, batchsize)
        except UnsupportedFusedTrain as e:
            reason, warn = f"outside the kernel envelope: {e}", True
    if reason is not None and device.type == "cuda":
        if warn:
            warnings.warn(
                f"train_ensemble: the whole-run kernel declined this "
                f"ensemble ({reason}); the plain program trains the members, "
                "one launch per operation", RuntimeWarning, stacklevel=2)
        if verbose:
            print(f"[fused-train kernel not used — {reason}; using the "
                  f"plain program over the members]")

    t0 = time.perf_counter()
    if folds is not None:
        hp = {}
        if type(optimizer) is Adam:
            hp = dict(lr=optimizer.learning_rate, b1=optimizer.b1,
                      b2=optimizer.b2, eps=optimizer.eps)
        tls, vls = _train_members_kernel(flows, folds, packed, arrays, perms,
                                         batchsize, hp)
        path, mode = "fused", "resident"
    else:
        opt = optimizer if optimizer is not None else Adam()
        local = [flows[i] for i in mine]
        run = (_train_members_vmapped if _one_program(local)
               else _train_members_plain)
        tls, vls = run(local, opt, arrays, perms[mine], batchsize, epochs,
                       shuffle)
        if mesh is not None:
            tls, vls = _gather_members(mesh, flows, mine, tls, vls, k)
        path, mode = "torch", None
    elapsed = time.perf_counter() - t0

    ens = EnsembleFlow(
        StackedModels([f.model for f in flows]), metadata, flows[0].base, k,
        train_loss=[[float(v) for v in tls[:, e]] for e in range(epochs)],
        valid_loss=[[float(v) for v in vls[:, e]] for e in range(epochs)],
        device=device)
    ens.trained_path = [path] * k
    ens.fused_decline_reason = [reason] * k
    ens.fused_kernel_mode = [mode] * k
    if verbose:
        print(f"[ensemble x{k} | {path} | {elapsed:.2f}s] final train NLL "
              "per member: " + ", ".join(f"{v:.4f}" for v in tls[:, -1]))
    return ens
