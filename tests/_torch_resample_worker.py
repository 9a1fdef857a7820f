"""Worker process of the port's two-rank resampling test (gloo, CPU).

Launched by ``tests/test_torch_resample.py``: each of ``world`` processes
joins a ``torch.distributed`` group through a FILE rendezvous, builds the
same log-weights and particles from numpy seeds (:func:`case_arrays`), takes
its contiguous block of them and runs
``parallel.resample.systematic_resample_sharded`` on it, once per case. It
writes ``resample_<rank>.npz`` with its output block per case.

This file imports torch, the port and ``_torch_cpu`` only.

usage: python _torch_resample_worker.py <rank> <world> <init_file> <out_dir>
       <cases.json>
"""

import json
import os
import sys

import numpy as np
import torch

import densityflows_tpu_torch as dt

import _torch_cpu  # noqa: F401


def case_arrays(name, n, d=3):
    """The full log-weights (n,) and particles (n, d) of a case."""
    rng = np.random.default_rng(5)
    particles = rng.normal(size=(n, d)).astype(np.float32)
    if name.startswith("random"):
        lw = (rng.normal(size=n) * 2.0).astype(np.float32)
    elif name.startswith("degenerate"):
        # all the mass on one row of the LAST block
        lw = np.full(n, -np.inf, np.float32)
        lw[n - n // 4] = 0.0
    elif name.startswith("first_block"):
        # all the mass in the first block
        lw = np.full(n, -30.0, np.float32)
        lw[: n // 4] = rng.normal(size=n // 4).astype(np.float32)
    else:
        raise ValueError(name)
    return lw, particles


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, out_dir = sys.argv[3], sys.argv[4]
    with open(sys.argv[5]) as f:
        cases = json.load(f)
    dt.distributed_init(f"file://{init}", world, rank, backend="gloo")
    mesh = dt.make_mesh()
    assert mesh.size == world and mesh.rank == rank
    out = {}
    try:
        for case in cases:
            lw, particles = case_arrays(case["name"], case["n"])
            rows = dt.host_local_rows(mesh, case["n"])
            kw = ({"u0": case["u0"]} if case.get("u0") is not None
                  else {})
            gen = torch.Generator().manual_seed(case.get("seed", 0) + rank)
            got = dt.systematic_resample_sharded(
                torch.as_tensor(lw[rows]), torch.as_tensor(particles[rows]),
                gen, mesh, **kw)
            out[case["label"]] = got.numpy()
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"resample_{rank}.npz"), **out)


if __name__ == "__main__":
    main()
