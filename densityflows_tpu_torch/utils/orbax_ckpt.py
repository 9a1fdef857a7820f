"""Sharded checkpoints on ``torch.distributed.checkpoint`` (the multi-rank
path).

PyTorch counterpart of ``densityflows_tpu/utils/orbax_ckpt.py``, under its
module and function names. The npz checkpoints (``utils.checkpoint``)
gather arrays to one process — fine on one card, wrong at scale: their
``save_flow`` of a tensor-parallel chain all-gathers every shard and both
Adam moments over the mesh's ``model`` axis. This backend stores the SAME
declarative spec JSON beside array stores of ``torch.distributed.checkpoint``
(DCP), PyTorch's own counterpart of Orbax, so:

- a tensor-parallel chain (``parallel.mesh.shard_params_tp``) saves and
  loads without any rank holding the whole model: each rank writes only its
  shards (every sharded leaf of a ``TensorParallelMLP``, and its two Adam
  moments, go in as a DTensor placed ``[Replicate(), Shard(dim)]`` on the
  ("data", "model") device mesh), and a load onto a mesh reads only this
  rank's chunks;
- the two formats stay interchangeable at the API level
  (``save_flow_orbax`` / ``load_flow_orbax`` mirror ``save_flow`` /
  ``load_flow``), and the specs are the npz format's.

A checkpoint directory holds ``flow.json`` (``"format":
"torch.distributed.checkpoint"``, ``model_spec``, ``base_spec``,
``metadata``, ``train_loss``, ``valid_loss``, ``has_opt_state``) beside the
DCP stores ``model/``, ``base/`` and, with optimizer state, ``opt_state/``;
each store is a ``.metadata`` file and one ``__<rank>_0.distcp`` per writing
rank. Keys: a leaf's npz name (``leaf_%05d``, in ``element_leaves`` order);
the Adam state as ``count`` (int32) and ``mu/leaf_%05d`` / ``nu/leaf_%05d``
for every model leaf (zeros for a buffer: the layout of
``adam_state_to_leaves``).

A checkpoint of the JAX package's ``save_flow_orbax`` (tensorstore arrays)
is not read here: the JAX package's ``load_flow_orbax`` then ``save_flow``
write it in the npz format, which ``load_flow`` reads.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import warnings

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.flow import Flow
from ..parallel.mesh import (
    _carries_cuda,
    _device_mesh,
    check_mesh,
    shard_params_tp,
)
from .checkpoint import (
    _adam_moments,
    _flow_record,
    _is_adam_state,
    _is_trainable,
    _leaf_key,
    _leaf_shard_dims,
    _metadata_from,
    _tp_nets,
    element_from_spec,
    element_leaves,
    element_spec,
)

__all__ = ["save_flow_orbax", "load_flow_orbax"]

FORMAT = "torch.distributed.checkpoint"
_STORES = ("model", "base", "opt_state")


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


@contextlib.contextmanager
def _store_call():
    # DCP warns that it "assumes the intent" of one process when it is told
    # so (no_dist=True)
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        yield


def _dist_kw(group) -> dict:
    return {"process_group": group} if group is not None else {"no_dist": True}


def _staged(t: torch.Tensor, shard, group):
    """What DCP is given for the leaf or moment ``t``: a DTensor of this
    rank's shard where ``shard`` is ``(mesh, dim)``, else the tensor itself;
    a host copy of a CUDA tensor unless ``group`` takes CUDA tensors (on
    gloo, and in one process, DCP writes from the host anyway)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    t = t.detach()
    if t.is_cuda and (group is None or not _carries_cuda(group)):
        t = t.cpu()
    if shard is None:
        return t
    mesh, dim = shard
    shape = list(t.shape)
    shape[dim] *= mesh.model_size
    return DTensor.from_local(
        t, _device_mesh(mesh), [Replicate(), Shard(dim)], run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def save_flow_orbax(directory: str, flow: Flow, opt_state=None) -> None:
    """Persist ``flow`` (+ an optional Adam state) with DCP array storage.

    Layout: ``flow.json`` (specs + metadata + histories) beside DCP stores
    ``model/``, ``base/`` and optionally ``opt_state/``; an existing
    checkpoint in ``directory`` is overwritten.

    Who calls it: for a tensor-parallel chain every rank of its mesh (a
    collective; each rank writes its own shards, DCP one copy of each
    replicated tensor); otherwise, where ``torch.distributed`` is
    initialised, every rank of the default group; in a single process the
    process alone. One rank writes ``flow.json`` once the arrays are
    written."""
    directory = os.path.abspath(directory)
    model = flow.model
    nets = _tp_nets(model)
    if nets:
        group = nets[0].mesh.world
        if group is None:
            raise ValueError(f"a tensor-parallel chain on {nets[0].mesh}, "
                             "a mesh without a process group")
    elif dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    else:
        group = None
    first = group is None or dist.get_rank(group) == 0
    if first:
        os.makedirs(directory, exist_ok=True)
        for store in _STORES:
            shutil.rmtree(os.path.join(directory, store), ignore_errors=True)
    _barrier(group)

    dims = _leaf_shard_dims(model)
    stores = {
        "model": {_leaf_key(i): _staged(t, dm, group) for i, (t, dm)
                  in enumerate(zip(element_leaves(model), dims))},
        "base": {_leaf_key(i): _staged(t, None, group)
                 for i, t in enumerate(element_leaves(flow.base))},
    }
    if opt_state is not None:
        state = {"count": torch.tensor(int(opt_state.count),
                                       dtype=torch.int32)}
        for name, moments in zip(("mu", "nu"),
                                 _adam_moments(model, opt_state)):
            state.update({f"{name}/{_leaf_key(i)}": _staged(m, dm, group)
                          for i, (m, dm) in enumerate(zip(moments, dims))})
        stores["opt_state"] = state
    dcp = _dcp()
    with _store_call():
        for store, state_dict in stores.items():
            dcp.save(state_dict, checkpoint_id=os.path.join(directory, store),
                     **_dist_kw(group))
    if first:
        with open(os.path.join(directory, "flow.json"), "w") as f:
            json.dump({"format": FORMAT, "model_spec": element_spec(model),
                       "base_spec": element_spec(flow.base),
                       **_flow_record(flow, opt_state)}, f, indent=1)
    _barrier(group)


def _check_format(directory: str, meta: dict) -> None:
    fmt = meta.get("format")
    if fmt == FORMAT:
        return
    if fmt == "orbax":
        raise ValueError(
            f"{directory} was written by the JAX package's save_flow_orbax: "
            "its arrays are Orbax / tensorstore stores, which this package "
            "does not read. Carry it across with the JAX package — "
            "densityflows_tpu.utils.orbax_ckpt.load_flow_orbax, then "
            "densityflows_tpu.save_flow (spec + npz) — and load that with "
            "load_flow")
    raise ValueError(
        f"{directory} is not a checkpoint of save_flow_orbax (flow.json "
        f"format {fmt!r}); a spec + npz checkpoint loads with load_flow")


def _read(path: str, wanted: dict, group) -> None:
    """Fill each tensor of ``wanted`` (``{key: (tensor, shard)}``) from the
    DCP store at ``path``: a DTensor target reads only this rank's chunk."""
    on_device = group is not None and _carries_cuda(group)
    targets = {k: _staged(torch.empty(t.shape, dtype=t.dtype, device=(
        t.device if on_device else "cpu")), dm, group)
        for k, (t, dm) in wanted.items()}
    with _store_call():
        _dcp().load(targets, checkpoint_id=path, **_dist_kw(group))
    with torch.no_grad():
        for k, (t, _) in wanted.items():
            got = targets[k]
            t.copy_(got.to_local() if hasattr(got, "to_local") else got)


def load_flow_orbax(directory: str, optimizer=None, *, mesh=None,
                    device=None):
    """Load a flow saved by :func:`save_flow_orbax` onto ``device``.

    ``mesh`` (a ``parallel.mesh.Mesh``) places the model as the JAX
    package's ``sharding_fn`` does: with a ``model`` axis of more than one
    rank it comes back laid out as ``shard_params_tp(mesh, ·)`` lays it out
    (a layer pair whose width the axis does not divide stays replicated),
    each rank reading only its own chunks (a collective over the mesh);
    without one, or with ``mesh=None``, every caller reads the whole
    replicated model. The mesh that wrote the checkpoint does not matter.

    Returns ``flow``, or ``(flow, opt_state)`` when ``optimizer`` (an
    :class:`~densityflows_tpu_torch.train.Adam`) is given and state was
    saved; its moments are placed as the model's leaves."""
    check_mesh(mesh)
    device = resolve_device(device)
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "flow.json")) as f:
        meta = json.load(f)
    _check_format(directory, meta)
    model = element_from_spec(meta["model_spec"], device)
    base = element_from_spec(meta["base_spec"], device)
    if mesh is not None and mesh.model_size > 1:
        model = shard_params_tp(mesh, model)
    dims = _leaf_shard_dims(model)
    group = mesh.world if any(dims) else None
    leaves = element_leaves(model)
    _read(os.path.join(directory, "model"),
          {_leaf_key(i): (t, dm)
           for i, (t, dm) in enumerate(zip(leaves, dims))}, group)
    _read(os.path.join(directory, "base"),
          {_leaf_key(i): (t, None)
           for i, t in enumerate(element_leaves(base))}, None)
    flow = Flow(model, _metadata_from(meta["metadata"]), base,
                meta["train_loss"], meta["valid_loss"], device=device)
    if optimizer is None or not meta.get("has_opt_state"):
        return flow
    trainable = [i for i, t in enumerate(leaves) if _is_trainable(t)]
    state = optimizer.init([leaves[i] for i in trainable])
    if not _is_adam_state(state):
        raise TypeError(
            "only an Adam state (count, mu, nu) is stored in a checkpoint, "
            f"got {type(state).__name__}")
    count = torch.zeros((), dtype=torch.int32)
    wanted = {"count": (count, None)}
    for name, moments in (("mu", state.mu), ("nu", state.nu)):
        wanted.update({f"{name}/{_leaf_key(i)}": (m, dims[i])
                       for i, m in zip(trainable, moments)})
    _read(os.path.join(directory, "opt_state"), wanted, group)
    return flow, type(state)(int(count), state.mu, state.nu)


def _stored_chunks(path: str) -> dict:
    """Per key of the DCP store at ``path``, its chunks as ``(offsets,
    sizes, file)``, read from the store's ``.metadata``: which rank file
    holds which part of each tensor."""
    from torch.distributed.checkpoint.metadata import MetadataIndex

    md = _dcp().FileSystemReader(path).read_metadata()
    return {key: [(tuple(c.offsets), tuple(c.sizes),
                   md.storage_data[MetadataIndex(key, c.offsets)]
                   .relative_path) for c in entry.chunks]
            for key, entry in md.state_dict_metadata.items()}
