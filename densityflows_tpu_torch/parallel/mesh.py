"""Data-parallel mesh: a thin object around a ``torch.distributed`` group.

PyTorch-port counterpart of ``densityflows_tpu/parallel/mesh.py``, its
data-parallel part. There a mesh is a grid of devices of one program and the
partitioner inserts the collectives; here one process drives one device, a
mesh is a process group with one ``data`` axis whose size is the group's world
size, and the training code calls the collectives itself: every rank runs the
step on ITS rows of a batch with the GLOBAL loss denominator, then loss and
gradients are summed over the ranks (``Mesh.all_reduce_``), so the summed
values equal the single-device ones.

There is no global array: each rank holds its own rows
(:func:`host_local_rows`, :func:`shard_batch`), and replicated values are
made equal by a broadcast from rank 0 (:func:`put_replicated`).

Tensor parallelism (the reference's ``model`` axis: ``mlp_tp_specs``,
``shard_params_tp``) is not ported; those names raise
``NotImplementedError``.
"""

from __future__ import annotations

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

_TP_MESSAGE = (
    "tensor parallelism (a mesh 'model' axis, mlp_tp_specs / shard_params_tp) "
    "is not ported: the port's mesh has the 'data' axis only")


class Mesh:
    """One ``data`` axis over the ranks of a process group.

    ``group is None`` is the trivial mesh of a single process that never
    initialised ``torch.distributed``: its collectives do nothing. With a
    group, every collective goes through it, also at world size 1."""

    axis_names = ("data",)

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        self.group, self.size, self.rank = group, int(size), int(rank)

    @property
    def shape(self) -> dict:
        return {"data": self.size}

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``tensor`` with rank ``src``'s (a rank of the group)."""
        if self.group is not None:
            dist.broadcast(tensor, dist.get_global_rank(self.group, src),
                           group=self.group)
        return tensor

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def __repr__(self):
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
    """Build the data-parallel mesh. Default: every rank of the default
    process group on one ``data`` axis; a process that never initialised
    ``torch.distributed`` gets the trivial mesh of size 1.

    ``shape`` must multiply to the world size, and every axis but ``data``
    must have size 1 (tensor parallelism is not ported)."""
    axis_names = tuple(axis_names)
    if "data" not in axis_names:
        raise ValueError(f"a mesh needs a 'data' axis, got {axis_names}")
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
    if any(s > 1 for s, a in zip(shape, axis_names) if a != "data"):
        raise NotImplementedError(_TP_MESSAGE)
    return Mesh(group, size, rank)


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
    mesh works on (a ceil split in rank order; late ranks may hold fewer)."""
    return _ceil_split(n_global, mesh.size, mesh.rank)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of batch-major arrays or tensors."""
    out = tuple(a[host_local_rows(mesh, a.shape[0])] for a in arrays)
    return out[0] if len(out) == 1 else out


def put_replicated(mesh: Mesh, tensors):
    """Make a tensor, or every tensor of a list, equal on all ranks: a
    broadcast from rank 0, in place. Returns its argument."""
    for t in ([tensors] if isinstance(tensors, torch.Tensor) else tensors):
        mesh.broadcast_(t)
    return tensors


def mlp_tp_specs(n_weights: int):
    raise NotImplementedError(_TP_MESSAGE)


def shard_params_tp(mesh, model):
    raise NotImplementedError(_TP_MESSAGE)
