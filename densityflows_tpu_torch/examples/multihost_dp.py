"""Data-parallel training over processes, runnable on one machine.

Counterpart of ``examples/multihost_dp.py``, which spawns two
``jax.distributed`` processes. Here each rank is a process of a
``torch.distributed`` group joined through a file rendezvous: two gloo
ranks on the CPU, or one NCCL rank on the card. Every rank builds the same
data and flow, ``train(mesh=...)`` works on its rows of every batch and the
ranks sum the gradients; rank 0 writes a checkpoint that every rank loads;
then one epoch of ``train_streaming(mesh=...)``, each rank streaming its own
shard.

Run: python -m densityflows_tpu_torch.examples.multihost_dp
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import densityflows_tpu_torch as dt

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def worker(rank: int, world: int, tmp: str, device: str,
           epochs: int) -> None:
    import torch.distributed as dist

    dt.distributed_init(f"file://{tmp}/rendezvous", world, rank,
                        backend="nccl" if device == "cuda" else "gloo")
    try:
        _train_on_rank(rank, tmp, torch.device(device), epochs)
    finally:
        dist.destroy_process_group()


def _train_on_rank(rank, tmp, device, epochs):
    # identical data and flow on every rank (deterministic); at scale each
    # rank would load only its rows (parallel.mesh.host_local_rows)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 8)).astype(np.float32)
    th = rng.uniform(0, 1, size=(4096, 2)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    chain = dt.flow_chain(
        dt.coupling_block(data, None, joint_conditioner=True,
                          generator=torch.Generator().manual_seed(0),
                          device=device),
        dt.normalization_layer(x, -1.0, 1.0, device=device),
    )
    flow = dt.Flow(chain, data, device=device)
    mesh = dt.make_mesh()
    print(f"[rank {rank}] {mesh.size} rank(s) on {device}")

    # the same generator seed on every rank: the batch order is one
    opt_state = dt.train(flow, data, dt.adam(1e-3), epochs=epochs,
                         batchsize=256, mesh=mesh,
                         generator=torch.Generator().manual_seed(7),
                         verbose=(rank == 0))

    # the checkpoint across the group: rank 0 writes, every rank loads
    ckpt = os.path.join(tmp, "checkpoint")
    if rank == 0:
        dt.save_flow(ckpt, flow, opt_state, erase=True)
    mesh.barrier()
    restored = dt.load_flow(ckpt, device=device)
    print(f"[rank {rank}] final train NLL {flow.train_loss[-1]:.4f} "
          f"({flow.trained_path}), checkpoint reload OK "
          f"({type(restored.model).__name__})")

    # streaming data parallelism: each rank streams its own shard
    dt.train_streaming(flow, x, th, dt.adam(1e-3), epochs=1, batchsize=128,
                       mesh=mesh, verbose=False)
    print(f"[rank {rank}] streaming-DP epoch NLL {flow.train_loss[-1]:.4f}")


def main(device=None, epochs: int = 5, timeout: float = 600.0):
    device = dt.resolve_device(device)
    world = 1 if device.type == "cuda" else 2
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "densityflows_tpu_torch.examples.multihost_dp", "--rank",
             str(rank), "--world", str(world), "--tmp", tmp, "--device",
             device.type, "--epochs", str(epochs)], env=env)
            for rank in range(world)]
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    print(f"data-parallel example: OK ({world} rank(s), {device.type})")
    return dict(world=world, exit_codes=codes)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--tmp", default=None)
    a = ap.parse_args()
    if a.rank is None:
        main(a.device, a.epochs)
    else:
        worker(a.rank, a.world, a.tmp, a.device, a.epochs)
