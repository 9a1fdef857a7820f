"""Worker process of the port's member-sharded ensemble test (gloo, CPU).

Launched by ``tests/test_torch_ensemble.py``: each of ``world`` processes
joins a ``torch.distributed`` group through a FILE rendezvous, builds the
same data and factory, and runs ``train_ensemble(mesh=make_mesh())``: each
rank trains its share of the members, the parameters and histories are
all-gathered at the end. It writes ``result_<rank>.json``; the parent holds
the results against the same call in one process (:func:`single_process`).
A member count the mesh does not divide must raise on every rank.

This file imports torch, the port and ``_torch_cpu`` only.

usage: python _torch_ensemble_worker.py <rank> <world> <init_file> <out_dir>
"""

import json
import os
import sys

import numpy as np
import torch

import densityflows_tpu_torch as dt

import _torch_cpu  # noqa: F401

K, EPOCHS, BATCH = 8, 2, 64


def build_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    th = rng.uniform(0, 1, size=(200, 1)).astype(np.float32)
    return x, dt.DataArrays.make(x, th, rng=0)


def factory(data):
    x = data.x

    def build(generator):
        return dt.flow_chain(
            dt.coupling_block(data, None, generator=generator,
                              hidden_dim_s=8, hidden_dim_t=8, device="cpu"),
            dt.normalization_layer(x, -1.0, 1.0, device="cpu"))
    return build


def single_process(mesh):
    """The ensemble of the test, on ``mesh`` (None: one process)."""
    _, data = build_data()
    ens = dt.train_ensemble(factory(data), data, n_members=K, epochs=EPOCHS,
                            batchsize=BATCH, optimizer=dt.adam(1e-3),
                            generator=torch.Generator().manual_seed(4),
                            verbose=False, mesh=mesh, device="cpu")
    return dict(train_loss=ens.train_loss, valid_loss=ens.valid_loss,
                leaves=[float(v) for l in ens.model.leaves()
                        for v in l.reshape(-1)],
                trained_path=ens.trained_path,
                decline=ens.fused_decline_reason)


def main(rank, world, init_file, out_dir):
    dt.distributed_init(f"file://{init_file}", world, rank, backend="gloo")
    mesh = dt.make_mesh()
    out = single_process(mesh)
    _, data = build_data()
    try:
        dt.train_ensemble(factory(data), data, n_members=3, epochs=1,
                          verbose=False, mesh=mesh, device="cpu")
        out["raised"] = None
    except ValueError as e:
        out["raised"] = str(e)
    mesh.barrier()
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
