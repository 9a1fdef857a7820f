"""Data- and tensor-parallel mesh: a thin object around ``torch.distributed``
groups.

PyTorch-port counterpart of ``densityflows_tpu/parallel/mesh.py``. There a
mesh is a grid of devices of one program and the partitioner inserts the
collectives; here one process drives one device, a mesh is a set of process
groups — one ``data`` axis, and optionally a ``model`` axis — and the code
calls the collectives itself.

- ``data``: every rank runs the step on ITS rows of a batch with the GLOBAL
  loss denominator, then loss and gradients are summed over the ranks of
  the axis (``Mesh.all_reduce_``), so the summed values equal the
  single-device ones. Serving and the inference engine split their row or
  particle axis the same way and gather the rows back
  (``Mesh.all_gather_rows``).
- ``model``: tensor parallelism of the conditioner MLPs
  (:func:`shard_params_tp`, :func:`mlp_tp_specs`): each rank of the axis
  holds one column / row shard of every layer pair, and the Megatron
  operators of ``ops/mlp.py`` sum the row-parallel products over the axis.

The ranks of a 2-D mesh are laid out row-major over its shape, as
``jax.make_mesh`` orders devices: ``rank = data_index × model_size +
model_index``. There is no global array: each rank holds its own rows
(:func:`host_local_rows`, :func:`shard_batch`), and replicated values are
made equal by a broadcast over the ``data`` axis from its rank 0
(:func:`put_replicated`; a ``model`` shard keeps its rank's values).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "distributed_init",
    "host_local_slice",
    "host_local_rows",
    "shard_batch",
    "put_replicated",
    "mlp_tp_specs",
    "shard_params_tp",
]

_AXES = ("data", "model")


def _carries_cuda(group) -> bool:
    """Whether ``group``'s backend takes CUDA tensors (NCCL does; gloo's
    collectives are run on a host copy)."""
    return "nccl" in str(dist.get_backend(group)).lower()


def _run(group, fn, tensors):
    """Run the collective ``fn(*tensors)`` over ``group``; CUDA tensors of a
    gloo group go through host copies, which are written back."""
    if group is None:
        return
    if any(t.is_cuda for t in tensors) and not _carries_cuda(group):
        host = [t.cpu() for t in tensors]
        fn(*host)
        for t, h in zip(tensors, host):
            t.copy_(h)
    else:
        fn(*tensors)


class Mesh:
    """A ``data`` axis and, on a 2-D mesh, a ``model`` axis over the ranks of
    a process group.

    ``group`` / ``size`` / ``rank`` are the ``data`` axis of this rank (the
    ranks that share its model index); ``model_group`` / ``model_size`` /
    ``model_rank`` its ``model`` axis; ``world`` the whole mesh. A group is
    None where its axis has one rank: the trivial mesh of a single process
    that never initialised ``torch.distributed`` has no group at all, and
    its collectives do nothing. Where a group exists every collective goes
    through it, also at size 1.

    Collectives run on the group's backend. A gloo group takes CPU tensors
    only for some collectives, so a CUDA tensor is copied to the host, the
    collective runs there, and the result is copied back (NCCL groups take
    the CUDA tensor itself)."""

    def __init__(self, group=None, size: int = 1, rank: int = 0, *,
                 model_group=None, model_size: int = 1, model_rank: int = 0,
                 world=None, axis_names: tuple = ("data",)):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.model_group = model_group
        self.model_size, self.model_rank = int(model_size), int(model_rank)
        self.world = world if world is not None else (
            group if self.model_size == 1 else None)
        self.axis_names = tuple(axis_names)
        self._device_mesh = None

    @property
    def shape(self) -> dict:
        sizes = {"data": self.size, "model": self.model_size}
        return {a: sizes[a] for a in self.axis_names}

    def __deepcopy__(self, memo):
        # a mesh names process groups: copies of a model share it
        return self

    def all_reduce_(self, tensor: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``tensor`` over the ``data`` axis (a sum by default), in
        place."""
        _run(self.group, lambda t: dist.all_reduce(t, op=op,
                                                    group=self.group),
             [tensor])
        return tensor

    def all_reduce_model_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ``model`` axis, in place."""
        _run(self.model_group,
             lambda t: dist.all_reduce(t, group=self.model_group), [tensor])
        return tensor

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``tensor`` with rank ``src``'s (a rank of the whole
        mesh, in its row-major order)."""
        if self.world is not None:
            root = dist.get_global_rank(self.world, src)
            _run(self.world,
                 lambda t: dist.broadcast(t, root, group=self.world),
                 [tensor])
        return tensor

    def broadcast_data_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Overwrite ``tensor`` with the one of data index 0 of this rank's
        ``data`` axis (a value sharded over ``model`` keeps its shard)."""
        if self.group is not None:
            root = dist.get_global_rank(self.group, 0)
            _run(self.group,
                 lambda t: dist.broadcast(t, root, group=self.group),
                 [tensor])
        return tensor

    def _gather(self, group, size, tensor):
        """The ``size`` ranks' equally shaped tensors, in rank order."""
        if group is None:
            return [tensor]
        tensor = tensor.contiguous()
        if tensor.is_cuda and not _carries_cuda(group):
            host = tensor.cpu()
            parts = [torch.empty_like(host) for _ in range(size)]
            dist.all_gather(parts, host, group=group)
            return [p.to(tensor.device) for p in parts]
        parts = [torch.empty_like(tensor) for _ in range(size)]
        dist.all_gather(parts, tensor, group=group)
        return parts

    def all_gather_rows(self, local: torch.Tensor,
                        n_global: int) -> torch.Tensor:
        """The whole ``(n_global, ...)`` tensor from every rank's
        :func:`host_local_rows` share of the ``data`` axis: one all-gather,
        each share padded to the largest (the ceil split's)."""
        if self.group is None:
            return local
        per = -(-n_global // self.size)
        if local.shape[0] < per:
            pad = local.new_zeros((per - local.shape[0],) + local.shape[1:])
            local = torch.cat([local, pad])
        return torch.cat(self._gather(self.group, self.size, local))[:n_global]

    def all_gather_model(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``model`` axis's shards of one tensor, joined along ``dim``."""
        return torch.cat(self._gather(self.model_group, self.model_size,
                                      shard), dim=dim)

    def barrier(self) -> None:
        if self.world is not None:
            dist.barrier(group=self.world)

    def __repr__(self):
        if "model" in self.axis_names:
            return (f"Mesh(data={self.size}, model={self.model_size}, "
                    f"rank=({self.rank}, {self.model_rank}))")
        return f"Mesh(data={self.size}, rank={self.rank})"


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     *, backend: str | None = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).
    Call once per process before :func:`make_mesh`; does nothing when no
    ``init_method`` is given and none is configured in the environment, or
    when the group exists already.

    ``init_method``: ``"tcp://host:port"`` or ``"file:///path"``, with
    ``world_size`` and ``rank`` given by the caller. ``backend``: by default
    gloo for CPU tensors and, where a CUDA device is present, NCCL for CUDA
    tensors."""
    import os

    if dist.is_initialized():
        return
    if init_method is None and world_size is None:
        if "MASTER_ADDR" not in os.environ:
            return
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend, init_method=init_method, **kw)


def make_mesh(shape: tuple | None = None,
              axis_names: tuple = ("data",), *, group=None) -> Mesh:
    """Build a mesh over the ranks of ``group`` (default: every rank of the
    default process group); a process that never initialised
    ``torch.distributed`` gets the trivial mesh of size 1.

    ``axis_names``: ``("data",)`` or ``("data", "model")``. ``shape`` must
    multiply to the group's size (default: every rank on ``data``). The
    ranks are laid out row-major over ``shape`` (``rank = data_index ×
    model_size + model_index``). Where both axes have more than one rank the
    mesh creates one subgroup per row and per column (``dist.new_group``),
    which every process of the default group must do, in the same order: so
    every process builds such a mesh, members of ``group`` or not."""
    axis_names = tuple(axis_names)
    if "data" not in axis_names:
        raise ValueError(f"a mesh needs a 'data' axis, got {axis_names}")
    if len(set(axis_names)) != len(axis_names) \
            or not set(axis_names) <= set(_AXES):
        raise ValueError(f"mesh axes are 'data' and 'model', got "
                         f"{axis_names}")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        size, rank = 1, 0
    else:
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    if shape is None:
        shape = tuple(size if a == "data" else 1 for a in axis_names)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{axis_names}")
    if int(np.prod(shape)) != size:
        raise ValueError(
            f"mesh shape {shape} does not match {size} process(es)")
    sizes = dict(zip(axis_names, shape))
    n_data, n_model = sizes["data"], sizes.get("model", 1)
    if group is None:
        return Mesh(axis_names=axis_names)
    if n_model == 1:
        return Mesh(group, n_data, rank, world=group, axis_names=axis_names)
    d_idx, m_idx = divmod(rank, n_model)
    if n_data == 1:
        return Mesh(None, 1, 0, model_group=group, model_size=n_model,
                    model_rank=m_idx, world=group, axis_names=axis_names)
    ranks = dist.get_process_group_ranks(group)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
        if m == m_idx:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
        if d == d_idx:
            model_group = g
    return Mesh(data_group, n_data, d_idx, model_group=model_group,
                model_size=n_model, model_rank=m_idx, world=group,
                axis_names=axis_names)


def _device_mesh(mesh: Mesh):
    """The ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh``'s ranks,
    with axes ("data", "model") laid out row-major as :func:`make_mesh` lays
    them: the placements of the sharded checkpoints' DTensors
    (``utils/orbax_ckpt.py``). Its device type is "cuda" where the mesh's
    group takes CUDA tensors (NCCL) and "cpu" on gloo, whose ranks hand the
    checkpoint host copies. Built once per mesh (every rank of the default
    group builds it, in the same order, as a 2-D :func:`make_mesh`)."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh._device_mesh is None:
        if mesh.world is None:
            raise ValueError(f"{mesh} has no process group to place "
                             "tensors on")
        ranks = dist.get_process_group_ranks(mesh.world)
        mesh._device_mesh = DeviceMesh(
            "cuda" if _carries_cuda(mesh.world) else "cpu",
            torch.tensor(ranks).reshape(mesh.size, mesh.model_size),
            mesh_dim_names=_AXES)
    return mesh._device_mesh


def check_mesh(mesh) -> None:
    """``mesh=`` arguments take a :class:`Mesh` (``make_mesh()``) or None."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a parallel.mesh.Mesh (make_mesh()), "
                        f"got {type(mesh).__name__}")


def _ceil_split(n_global: int, size: int, rank: int) -> slice:
    per = -(-n_global // size)
    lo = min(rank * per, n_global)
    return slice(lo, min(lo + per, n_global))


def host_local_slice(n_global: int) -> slice:
    """This process's contiguous row range of a data set split evenly (ceil)
    over the processes of the default group — load only these rows from
    disk on each host."""
    if dist.is_available() and dist.is_initialized():
        return _ceil_split(n_global, dist.get_world_size(), dist.get_rank())
    return slice(0, n_global)


def host_local_rows(mesh: Mesh, n_global: int) -> slice:
    """The contiguous range of ``n_global`` batch rows that THIS rank of the
    mesh works on: a ceil split over the ``data`` axis in rank order (late
    ranks may hold fewer); the ranks of one ``model`` axis share it."""
    return _ceil_split(n_global, mesh.size, mesh.rank)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of batch-major arrays or tensors."""
    out = tuple(a[host_local_rows(mesh, a.shape[0])] for a in arrays)
    return out[0] if len(out) == 1 else out


def put_replicated(mesh: Mesh, tensors):
    """Make a tensor, or every tensor of a list, equal on all ranks of each
    ``data`` axis of the mesh: a broadcast from data index 0, in place
    (:meth:`Mesh.broadcast_data_`). On a one-axis mesh that is every rank;
    on a 2-D mesh a tensor sharded over ``model`` keeps each rank's shard.
    Returns its argument."""
    for t in ([tensors] if isinstance(tensors, torch.Tensor) else tensors):
        mesh.broadcast_data_(t)
    return tensors


def mlp_tp_specs(n_weights: int):
    """Megatron placement of one conditioner MLP with ``n_weights`` dense
    layers, as tuples of axis names per dimension: consecutive layer PAIRS
    are (column-parallel, row-parallel) — layer 2k shards its OUTPUT axis
    ``(None, "model")`` with its bias ``("model",)``; layer 2k+1 shards its
    INPUT axis ``("model", None)`` with a replicated bias ``()``, and one sum
    over the ``model`` axis follows it. An unpaired trailing layer is
    replicated (``()`` for both).

    Returns ``(weight_specs, bias_specs)``, lists of length ``n_weights``."""
    w_specs: list = []
    b_specs: list = []
    i = 0
    while i + 1 < n_weights:
        w_specs += [(None, "model"), ("model", None)]
        b_specs += [("model",), ()]
        i += 2
    if i < n_weights:
        w_specs.append(())
        b_specs.append(())
    return w_specs, b_specs


def shard_params_tp(mesh: Mesh, model):
    """A copy of ``model`` with every conditioner
    :class:`~densityflows_tpu_torch.ops.mlp.MLP` tensor-parallel over the
    mesh's ``model`` axis: each becomes a
    :class:`~densityflows_tpu_torch.ops.mlp.TensorParallelMLP` that holds
    only this rank's column and row shards (:func:`mlp_tp_specs`); every
    other leaf — masked autoregressive nets, normalization constants,
    spline parameters — stays replicated. A layer pair whose hidden width
    the ``model`` size does not divide stays replicated.

    At ``model`` size 1 nothing is sharded: the copy is the replicated
    model, and the chain and whole-run kernels take it as they take any
    chain. A tensor-parallel copy is declined by them (visibly: see
    ``models/fused_chain.py`` and ``models/fused_train.py``)."""
    from ..ops.mlp import MLP, TensorParallelMLP

    out = copy.deepcopy(model)
    if mesh.model_size == 1:
        return out
    if type(out) is MLP:
        return TensorParallelMLP.shard(out, mesh)

    def swap(module):
        for name, child in list(module.named_children()):
            if type(child) is MLP:
                setattr(module, name, TensorParallelMLP.shard(child, mesh))
            else:
                swap(child)

    swap(out)
    return out
