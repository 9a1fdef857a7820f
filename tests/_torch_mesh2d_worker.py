"""Worker process of the port's two- and four-rank mesh tests (gloo, CPU):
tensor parallelism on a 2-D mesh, ``mesh=`` on serving and on the inference
engine, the scaling harness, and sharded checkpoints.

Launched by ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_mesh_serving.py``, ``tests/test_torch_instruments.py``
and ``tests/test_torch_orbax_ckpt.py`` (through :func:`run_ranks`): each of
``world`` processes joins a
``torch.distributed`` group through a FILE rendezvous, loads the flows and
arrays the parent wrote into ``<dir>``, runs the mode's entry points with a
mesh, and writes ``<mode>_<rank>.npz``. The parent holds them against the
same calls in one process and against the JAX package.

This file imports torch, the port and ``_torch_cpu`` only.

usage: python _torch_mesh2d_worker.py <mode> <rank> <world> <init_file> <dir>
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch import inference as tinf
from densityflows_tpu_torch.models.fused_train import (
    UnsupportedFusedTrain,
    fused_step_mesh_reason,
    trainable_leaves,
)
from densityflows_tpu_torch.parallel.mesh import shard_params_tp
from densityflows_tpu_torch.utils.checkpoint import (
    _gather_tp,
    adam_state_to_leaves,
    element_leaves,
)
from densityflows_tpu_torch.utils.orbax_ckpt import (
    load_flow_orbax,
    save_flow_orbax,
)

import _torch_cpu  # noqa: F401

TP_EPOCHS, TP_BATCH = 2, 32
# sharded checkpoints: steps before the save, steps after it, batch rows
CK_STEPS, CK_MORE, CK_BATCH = 2, 2, 32


def gen(seed):
    return torch.Generator().manual_seed(seed)


def flat_leaves(model):
    return np.concatenate([p.detach().reshape(-1).detach().numpy()
                           for p in trainable_leaves(model)])


class Fed(tinf._Draws):
    """Draws handed out in order from the arrays the parent wrote (another
    program's draws, in that program's order)."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def _next(self, shape):
        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(np.array(a))

    def base(self, base, shape):
        return self._next(tuple(shape) + (base.d,))

    def normal(self, shape):
        return self._next(shape)

    def uniform(self, shape):
        return self._next(shape)


def fed(arrays, prefix):
    keys = sorted((k for k in arrays.files if k.startswith(prefix)),
                  key=lambda k: int(k[len(prefix):]))
    return Fed([arrays[k] for k in keys])


def gauss_logp(mu, sc):
    mu = torch.as_tensor(np.asarray(mu, np.float32))
    sc = torch.as_tensor(np.asarray(sc, np.float32))

    def logp(x):
        u = (x - mu) / sc
        return -0.5 * (u * u).sum(-1)

    return logp


# -- the modes ---------------------------------------------------------------

def tensor_parallel(folder):
    """make_train_step, train() and train_streaming() on a (1, 2) ("data",
    "model") mesh with the chain placed by shard_params_tp, against the
    replicated chain in this process; the step kernel's decline; a (2, 1)
    mesh; save_flow."""
    def load():
        return dt.load_flow(os.path.join(folder, "flow"), device="cpu")

    b = np.load(os.path.join(folder, "batch.npz"))
    x, th, mask = (torch.as_tensor(b[k]) for k in ("x", "th", "mask"))
    mesh = dt.make_mesh((1, 2), ("data", "model"))
    assert mesh.shape == {"data": 1, "model": 2}
    out = {}

    opt = dt.adam(1e-3)
    rep, tp = load(), load()
    tp.model = shard_params_tp(mesh, tp.model)
    steps = {"rep": dt.make_train_step(opt),
             "tp": dt.make_train_step(opt, mesh=mesh)}
    for name, flow in (("rep", rep), ("tp", tp)):
        state = opt.init(trainable_leaves(flow.model))
        losses = []
        for _ in range(2):
            _, state, loss = steps[name](flow.model, state, flow.base, x, th,
                                         mask)
            losses.append(float(loss))
        out[f"step_loss_{name}"] = np.asarray(losses)
    out["step_params_rep"] = flat_leaves(rep.model)
    out["step_params_tp"] = flat_leaves(_gather_tp(tp.model, None)[0])
    out["shard_shapes"] = np.asarray(
        [p.numel() for p in trainable_leaves(tp.model)])

    data = dt.DataArrays.make(b["x_all"], b["th_all"], rng=0)
    perms = b["perms"]
    rep, tp = load(), load()
    tp.model = shard_params_tp(mesh, tp.model)
    kw = dict(epochs=TP_EPOCHS, batchsize=TP_BATCH, verbose=False,
              _epoch_perms=perms)
    dt.train(rep, data, dt.adam(1e-3), fused_kernel=False, **kw)
    state = dt.train(tp, data, dt.adam(1e-3), mesh=mesh, **kw)
    out["train_rep"] = np.asarray([rep.train_loss, rep.valid_loss])
    out["train_tp"] = np.asarray([tp.train_loss, tp.valid_loss])
    out["train_params_rep"] = flat_leaves(rep.model)
    out["train_params_tp"] = flat_leaves(_gather_tp(tp.model, None)[0])
    info = dict(path=tp.trained_path, reason=tp.fused_decline_reason)
    forced = load()
    forced.model = shard_params_tp(mesh, forced.model)
    try:
        dt.train(forced, data, dt.adam(1e-3), mesh=mesh, fused_kernel=True,
                 **kw)
    except UnsupportedFusedTrain as e:
        info["forced"] = str(e)
    # train_streaming on the same mesh: every rank trains its own shards
    srep, stp = load(), load()
    stp.model = shard_params_tp(mesh, stp.model)
    skw = dict(epochs=TP_EPOCHS, batchsize=TP_BATCH, verbose=False, seed=3)
    dt.train_streaming(srep, b["x_all"], b["th_all"], dt.adam(1e-3),
                       fused_kernel=False, **skw)
    dt.train_streaming(stp, b["x_all"], b["th_all"], dt.adam(1e-3), mesh=mesh,
                       **skw)
    out["stream_rep"] = np.asarray(srep.train_loss)
    out["stream_tp"] = np.asarray(stp.train_loss)
    out["stream_params_rep"] = flat_leaves(srep.model)
    out["stream_params_tp"] = flat_leaves(_gather_tp(stp.model, None)[0])
    forced = load()
    forced.model = shard_params_tp(mesh, forced.model)
    try:
        dt.train_streaming(forced, b["x_all"], b["th_all"], dt.adam(1e-3),
                           mesh=mesh, fused_kernel=True, **skw)
    except UnsupportedFusedTrain as e:
        info["stream_forced"] = str(e)
    # checkpoints: the trained shards with their Adam state, and a freshly
    # placed chain beside the replicated one
    dt.save_flow(os.path.join(folder, "tp_trained"), tp, state, erase=True)
    fresh = load()
    fresh.model = shard_params_tp(mesh, fresh.model)
    dt.save_flow(os.path.join(folder, "tp_saved"), fresh, erase=True)
    if mesh.model_rank == 0:
        dt.save_flow(os.path.join(folder, "rep_saved"), load(), erase=True)

    # a (2, 1) mesh is data-parallel: the step kernel takes it
    mesh21 = dt.make_mesh((2, 1), ("data", "model"))
    flow = load()
    info["reason_2x1"] = fused_step_mesh_reason(flow, TP_BATCH, mesh21)
    dt.train(flow, data, dt.adam(1e-3), mesh=mesh21, fused_kernel=True,
             **dict(kw, epochs=1, _epoch_perms=perms[:1]))
    info["path_2x1"] = flow.trained_path
    out["info"] = np.asarray(json.dumps(info))
    return out


def serving(folder):
    """log_prob / sample / sample_sweep with mesh= on a two-rank data mesh
    (and the same through the chain route's plain versions)."""
    flow = dt.load_flow(os.path.join(folder, "flow"), device="cpu")
    b = np.load(os.path.join(folder, "serving.npz"))
    mesh = dt.make_mesh()
    out = {}
    for route in ("auto", True):
        dt.set_fused_kernels(route)
        try:
            tag = "chain" if route is True else "plain"
            out[f"lp_{tag}"] = flow.log_prob(b["x"], b["th"],
                                             mesh=mesh).detach().numpy()
            out[f"sample_{tag}"] = flow.sample(
                (640,), (0.3, 0.7), generator=gen(1),
                mesh=mesh).detach().numpy()
            out[f"sample_rows_{tag}"] = flow.sample(
                (5, 7), b["th"][:35].reshape(5, 7, 2), generator=gen(4),
                mesh=mesh).detach().numpy()
            out[f"sweep_{tag}"] = flow.sample_sweep(
                b["thetas"], 16, generator=gen(2), mesh=mesh).detach().numpy()
        finally:
            dt.set_fused_kernels("auto")
    mesh21 = dt.make_mesh((2, 1), ("data", "model"))
    out["lp_2x1"] = flow.log_prob(b["x"], b["th"],
                                  mesh=mesh21).detach().numpy()
    try:
        flow.log_prob((np.linspace(-1, 1, 4),) * 4, (0.3, 0.7), mesh=mesh)
    except ValueError as e:
        out["grid"] = np.asarray(str(e))
    return out


def inference(folder):
    """The four particle entry points with mesh= on the draws the parent
    wrote (the JAX program's)."""
    a = np.load(os.path.join(folder, "draws.npz"))
    mesh = dt.make_mesh()
    out = {}
    flow = dt.load_flow(os.path.join(folder, "rej_flow"), device="cpu")
    out["rejection"] = dt.sample_with_rejection(
        flow, 150, lambda v: v[..., 0] > 0.3, (0.5,), batch=64,
        _draws=fed(a, "rej"), mesh=mesh).detach().numpy()
    flow = dt.load_flow(os.path.join(folder, "mcmc_flow"), device="cpu")
    logp = gauss_logp([0.5, -0.5], [0.9, 1.1])
    for method in ("independence", "neutra"):
        s, diag = dt.flow_mcmc(
            flow, logp, theta=(0.4,), n_chains=64, n_steps=5, burn_in=1,
            method=method, step_size=0.6, _draws=fed(a, f"mcmc_{method}"),
            mesh=mesh)
        out[f"mcmc_{method}"] = s.numpy()
        out[f"mcmc_{method}_acc"] = diag["accept_rate"].numpy()
        out[f"mcmc_{method}_rhat"] = diag["r_hat"]
    flow = dt.load_flow(os.path.join(folder, "vi_flow"), device="cpu")
    state = dt.fit_variational(
        flow, gauss_logp([1.0, -0.5], [0.7, 0.7]), theta=(0.3,), steps=8,
        n_particles=64, _draws=fed(a, "vi"), mesh=mesh)
    out["vi_loss"] = np.asarray(flow.train_loss)
    out["vi_params"] = flat_leaves(flow.model)
    out["vi_count"] = np.asarray(state.count)
    parts, log_w, diag = dt.run_smc(
        gauss_logp([2.0, -1.0], [1.0, 1.0]), 2, 256, n_steps=6,
        init_scale=3.0, generator=gen(9), mh_step_size=0.5, n_mh=2,
        mesh=mesh, device="cpu")
    out["smc_particles"], out["smc_log_w"] = parts.numpy(), log_w.numpy()
    out["smc_ess"] = diag["ess"].numpy()
    out["smc_acc"] = diag["mh_accept"].numpy()
    return out


def scaling(folder):
    """scaling_report over the first 1 and 2 ranks."""
    from densityflows_tpu_torch.parallel.scaling import scaling_report

    def make_model(generator):
        return dt.flow_chain(dt.coupling_block(
            4, None, n=1, generator=generator, hidden_dim_s=8,
            hidden_dim_t=8, device="cpu"))

    pts = scaling_report(make_model, d=4, n_cond=1, per_device_batch=64,
                         reps=2, device_counts=[1, 2], device="cpu")
    return {"points": np.asarray(json.dumps(
        [list(vars(p).values()) for p in pts]))}


def leaf_arrays(prefix, tensors):
    """Copies of ``tensors`` (a step updates leaves in place)."""
    return {f"{prefix}_{i}": t.detach().numpy().copy()
            for i, t in enumerate(tensors)}


def checkpoints(folder):
    """save_flow_orbax of a chain trained tensor-parallel on a (1, 2) mesh
    (with its Adam state), then load_flow_orbax of it onto the same mesh
    (2 more steps, against the run that went on without the checkpoint)
    and onto a (2, 1) mesh, and of a one-process checkpoint onto the (1, 2)
    mesh."""
    b = np.load(os.path.join(folder, "ckpt_batch.npz"))
    x, th = torch.as_tensor(b["x"]), torch.as_tensor(b["th"])
    mask = torch.ones(CK_BATCH)
    mesh = dt.make_mesh((1, 2), ("data", "model"))
    opt = dt.adam(1e-3)
    step = dt.make_train_step(opt, mesh=mesh)
    saved = os.path.join(folder, "tp_ckpt")

    def run(flow, state, steps):
        losses = []
        for i in steps:
            rows = slice(i * CK_BATCH, (i + 1) * CK_BATCH)
            _, state, loss = step(flow.model, state, flow.base, x[rows],
                                  th[rows], mask)
            losses.append(float(loss))
        return state, losses

    flow = dt.load_flow(os.path.join(folder, "flow"), device="cpu")
    flow.model = shard_params_tp(mesh, flow.model)
    state, first = run(flow, opt.init(trainable_leaves(flow.model)),
                       range(CK_STEPS))
    flow.train_loss = first
    save_flow_orbax(saved, flow, state)
    out = dict(leaf_arrays("saved", element_leaves(flow.model)),
               **leaf_arrays("saved_mu", state.mu),
               **leaf_arrays("saved_nu", state.nu))
    gathered, gstate = _gather_tp(flow.model, state)
    out.update(leaf_arrays("gathered", element_leaves(gathered)))
    out.update({f"gathered_adam_{i}": a for i, a in
                enumerate(adam_state_to_leaves(gathered, gstate))})
    _, rest = run(flow, state, range(CK_STEPS, CK_STEPS + CK_MORE))
    out["uninterrupted_losses"] = np.asarray(first + rest)
    out.update(leaf_arrays("uninterrupted", element_leaves(flow.model)))

    loaded, lstate = load_flow_orbax(saved, opt, mesh=mesh, device="cpu")
    out.update(leaf_arrays("loaded", element_leaves(loaded.model)))
    out.update(leaf_arrays("loaded_mu", lstate.mu))
    out.update(leaf_arrays("loaded_nu", lstate.nu))
    out["loaded_count"] = np.asarray(lstate.count)
    out["loaded_train_loss"] = np.asarray(loaded.train_loss)
    specs = lambda m: [[list(map(list, n.weight_specs)),  # noqa: E731
                        list(map(list, n.bias_specs))]
                       for n in m.modules() if hasattr(n, "weight_specs")]
    out["specs"] = np.asarray(json.dumps([specs(flow.model),
                                          specs(loaded.model)]))
    _, resumed = run(loaded, lstate, range(CK_STEPS, CK_STEPS + CK_MORE))
    out["resumed_losses"] = np.asarray(first + resumed)
    out.update(leaf_arrays("resumed", element_leaves(loaded.model)))

    mesh21 = dt.make_mesh((2, 1), ("data", "model"))
    flow21 = load_flow_orbax(saved, mesh=mesh21, device="cpu")
    out.update(leaf_arrays("leaves_2x1", element_leaves(flow21.model)))
    with torch.no_grad():
        out["lp_2x1"] = flow21.log_prob(b["xe"], b["the"],
                                        mesh=mesh21).numpy()

    onto = load_flow_orbax(os.path.join(folder, "rep_ckpt"), mesh=mesh,
                           device="cpu")
    placed = shard_params_tp(
        mesh, dt.load_flow(os.path.join(folder, "flow"), device="cpu").model)
    out.update(leaf_arrays("onto", element_leaves(onto.model)))
    out.update(leaf_arrays("placed", element_leaves(placed)))
    out["onto_specs"] = np.asarray(json.dumps([specs(onto.model),
                                               specs(placed)]))
    return out


def checkpoints_2x2(folder):
    """On four ranks: one data-parallel, tensor-parallel step on a (2, 2)
    mesh, save_flow_orbax (each shard held by both data rows), and
    load_flow_orbax onto the same mesh."""
    b = np.load(os.path.join(folder, "ckpt_batch.npz"))
    mesh = dt.make_mesh((2, 2), ("data", "model"))
    opt = dt.adam(1e-3)
    flow = dt.load_flow(os.path.join(folder, "flow"), device="cpu")
    flow.model = shard_params_tp(mesh, flow.model)
    rows = slice(mesh.rank * CK_BATCH // 2, (mesh.rank + 1) * CK_BATCH // 2)
    _, state, _ = dt.make_train_step(opt, mesh=mesh)(
        flow.model, opt.init(trainable_leaves(flow.model)), flow.base,
        torch.as_tensor(b["x"][rows]), torch.as_tensor(b["th"][rows]),
        torch.ones(CK_BATCH // 2), denom=torch.tensor(float(CK_BATCH)))
    save_flow_orbax(os.path.join(folder, "ckpt_2x2"), flow, state)
    loaded, lstate = load_flow_orbax(os.path.join(folder, "ckpt_2x2"), opt,
                                     mesh=mesh, device="cpu")
    out = dict(leaf_arrays("saved", element_leaves(flow.model)),
               **leaf_arrays("loaded", element_leaves(loaded.model)),
               **leaf_arrays("saved_mu", state.mu + state.nu),
               **leaf_arrays("loaded_mu", lstate.mu + lstate.nu))
    gathered, gstate = _gather_tp(flow.model, state)
    out.update(leaf_arrays("gathered", element_leaves(gathered)))
    out.update({f"gathered_adam_{i}": a for i, a in
                enumerate(adam_state_to_leaves(gathered, gstate))})
    out["place"] = np.asarray([mesh.rank, mesh.model_rank])
    return out


MODES = dict(tp=tensor_parallel, serving=serving, inference=inference,
             scaling=scaling, ckpt=checkpoints, ckpt22=checkpoints_2x2)


def run_ranks(mode, folder, world=2, timeout=180):
    """Start ``world`` workers in ``mode`` on ``folder`` (a file rendezvous
    inside it) and return their ``<mode>_<rank>.npz`` contents; raise with
    the ranks' logs if one fails or runs past ``timeout`` seconds."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(tests), tests, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    init = os.path.join(folder, f"rendezvous_{mode}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         init, folder], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            logs.append(o[-2000:] + e[-4000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[1][-4000:] for p in procs]
        raise AssertionError("a rank did not finish in time:\n"
                             + "\n---\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(os.path.join(folder, f"{mode}_{r}.npz")))
            for r in range(world)]


def main() -> None:
    mode, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    init_file, folder = sys.argv[4], sys.argv[5]
    dt.distributed_init(f"file://{init_file}", world, rank, backend="gloo")
    out = MODES[mode](folder)
    dt.make_mesh().barrier()
    np.savez(os.path.join(folder, f"{mode}_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
