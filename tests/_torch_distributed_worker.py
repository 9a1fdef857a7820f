"""Worker process of the port's two-rank data-parallel test (gloo, CPU).

Launched by ``tests/test_torch_mesh.py``: each of ``world`` processes joins a
``torch.distributed`` group through a FILE rendezvous (no port to lose),
builds the same data and flow from numpy seeds, and runs the real
data-parallel paths on its shard — the per-batch step
(``make_fused_step_fn``), ``train(mesh=...)`` on the step-kernel program and
on the plain program, and ``train_streaming(mesh=...)`` with its own loader
shard. It writes ``result_<rank>.json``; the parent holds the results against
the same runs in one process (:func:`single_process_reference`).

This file imports torch, the port and ``_torch_cpu`` only.

usage: python _torch_distributed_worker.py <rank> <world> <init_file> <out_dir>
"""

import json
import os
import sys

import numpy as np
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models.fused_train import (
    fold_for_step,
    trainable_leaves,
)
from densityflows_tpu_torch.train import _fold_adam_state

import _torch_cpu  # noqa: F401

EPOCHS, BATCH, STREAM_BATCH = 2, 32, 16
HP = dict(lr=2e-3, b1=0.9, b2=0.999, eps=1e-8)


def build_case():
    """Data and a flow builder, identical in every process."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(200, 2)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)

    def build():
        g = torch.Generator().manual_seed(3)
        kw = dict(hidden_dim_s=8, hidden_dim_t=8, generator=g, device="cpu",
                  zero_init_final=False)
        return dt.Flow(dt.flow_chain(
            dt.coupling_layer(data, [0, 1], **kw),
            dt.coupling_layer(data, [2, 3], joint_conditioner=True, **kw),
            dt.normalization_layer(x, -1.0, 1.0, device="cpu")), data,
            device="cpu")

    n_train = len(data.partition.training)
    perms = np.stack([np.random.default_rng(10 + e).permutation(n_train)
                      for e in range(EPOCHS)])
    return x, th, data, build, perms


def _leaves(flow):
    return [p.detach().reshape(-1).tolist()
            for p in trainable_leaves(flow.model)]


def step_fn_losses(mesh, x, th, build):
    """Six batches of BATCH rows through ``make_fused_step_fn``; with a mesh
    every rank passes its rows of each batch. The last batch is ragged: its
    mask zeroes the rows past the data's end."""
    flow = build()
    folded = fold_for_step(flow)
    sp = folded.step_plan
    flat_p = sp.flatten(folded.tparams)
    fstate = _fold_adam_state(folded, None)
    step = dt.make_fused_step_fn(mesh, sp, **HP)
    th01 = dt.normalize_input(th, flow.metadata.theta_min,
                              flow.metadata.theta_max).astype(np.float32)
    losses = []
    for b in range(6):
        rows = np.arange(b * BATCH, (b + 1) * BATCH) % x.shape[0]
        mask = (np.arange(BATCH) < (BATCH if b < 5 else 9)).astype(np.float32)
        parts = [torch.as_tensor(a) for a in (x[rows], th01[rows], mask)]
        if mesh is not None:
            parts = dt.shard_batch(mesh, *parts)
        flat_p, fstate, loss = step(flat_p, fstate, *parts)
        losses.append(float(loss))
    return losses, flat_p.tolist(), fstate.count


def run_paths(mesh, x, th, data, build, perms):
    out = {}
    out["step_losses"], out["step_params"], out["step_count"] = \
        step_fn_losses(mesh, x, th, build)
    for name, fused in (("fused", True), ("plain", False)):
        flow = build()
        kw = dict(mesh=mesh) if mesh is not None else {}
        if mesh is None and fused:
            continue        # one process: the plain program is the reference
        state = dt.train(flow, data, dt.adam(HP["lr"]),
                         epochs=EPOCHS, batchsize=BATCH, verbose=False,
                         fused_kernel=fused, _epoch_perms=perms, **kw)
        out[f"train_{name}"] = dict(
            path=flow.trained_path, train_loss=flow.train_loss,
            valid_loss=flow.valid_loss, leaves=_leaves(flow),
            count=state.count)
    return out


def stream(mesh, x, th, build, fused):
    flow = build()
    state = dt.train_streaming(
        flow, x, th, dt.adam(HP["lr"]), epochs=EPOCHS, batchsize=STREAM_BATCH,
        seed=5, verbose=False, mesh=mesh, fused_kernel=fused,
        valid_data=(x[:40], th[:40]))
    return dict(path=flow.trained_path, train_loss=flow.train_loss,
                valid_loss=flow.valid_loss, leaves=_leaves(flow),
                count=state.count)


def single_process_reference():
    """The same runs in one process. The streaming reference steps on the
    concatenation of the two ranks' loader batches: one loader per shard,
    one global batch per step."""
    x, th, data, build, perms = build_case()
    out = run_paths(None, x, th, data, build, perms)

    flow = build()
    md = flow.metadata
    loaders = [dt.StreamingLoader(x, th, batchsize=STREAM_BATCH, seed=5,
                                  host_id=h, num_hosts=2) for h in range(2)]
    optimizer = dt.adam(HP["lr"])
    step = dt.make_train_step(optimizer)
    state = optimizer.init(trainable_leaves(flow.model))
    hist = []
    for e in range(EPOCHS):
        losses, weights = [], []
        for parts in zip(*[ld.epoch(e) for ld in loaders]):
            xb, thb, mask = (np.concatenate(a) for a in zip(*parts))
            thb = dt.normalize_input(thb, md.theta_min, md.theta_max)
            _, state, loss = step(
                flow.model, state, flow.base, torch.as_tensor(xb),
                torch.as_tensor(thb.astype(np.float32)),
                torch.as_tensor(mask))
            losses.append(float(loss))
            weights.append(float(mask.sum()))
        hist.append(float(np.dot(losses, weights) / sum(weights)))
    out["stream"] = dict(train_loss=hist, leaves=_leaves(flow),
                         count=state.count)
    return out


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out_dir = sys.argv[3], sys.argv[4]
    dt.distributed_init(f"file://{init_file}", world, rank, backend="gloo")
    mesh = dt.make_mesh()
    assert (mesh.size, mesh.rank) == (world, rank)
    assert mesh.shape == {"data": world}

    x, th, data, build, perms = build_case()
    # the other rank draws ANOTHER batch order: rank 0's must be the one used
    other = perms if rank == 0 else perms[:, ::-1].copy()
    out = run_paths(mesh, x, th, data, build, other)
    out["stream_fused"] = stream(mesh, x, th, build, True)
    out["stream_plain"] = stream(mesh, x, th, build, False)

    # replicated values: a broadcast from rank 0
    t = torch.full((3,), float(rank))
    dt.put_replicated(mesh, t)
    out["replicated"] = t.tolist()
    mesh.barrier()
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
