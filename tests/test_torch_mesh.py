"""Data parallelism of the port on the CPU (``parallel/mesh.py``, the mesh
paths of ``train`` and ``train_streaming``): the mesh object, the plain and
the step-kernel data-parallel programs on a one-rank gloo group in this
process, against the JAX package's ``train(mesh=...)`` on its virtual
devices, and two ranks in two processes against one process.

Tolerance: float32 on every side, gradients summed over ranks or devices in
another order: 1e-4 on losses and histories, 1e-3 on parameters after a few
epochs of Adam, as stated in each test. The two-rank test uses a FILE
rendezvous (no port) and a time limit per process.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.models.fused_train import UnsupportedFusedTrain
from densityflows_tpu_torch.ops import step_kernels as SK
from densityflows_tpu_torch.parallel import mesh as M

import _torch_distributed_worker as W
from _torch_parity import (
    assert_leaves_close,
    cond_data,
    jax_epoch_perms,
    randomize,
    torch_flow,
)

ATOL, PARAM_ATOL = 1e-4, 1e-3
_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)


@pytest.fixture(scope="module")
def group_mesh(tmp_path_factory):
    """A real one-rank gloo group (file rendezvous) around this process:
    every collective of the mesh runs through ``torch.distributed``."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dt.distributed_init(f"file://{path}", 1, 0, backend="gloo")
    assert dist.is_initialized()
    yield dt.make_mesh()
    dist.destroy_process_group()


# -- the mesh object -----------------------------------------------------------

def test_trivial_mesh_needs_no_process_group():
    assert not dist.is_initialized()
    dt.distributed_init()            # nothing configured: does nothing
    assert not dist.is_initialized()
    mesh = dt.make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    t = torch.arange(3.0)
    assert mesh.all_reduce_(t) is t and mesh.broadcast_(t) is t
    mesh.barrier()
    assert torch.equal(dt.put_replicated(mesh, [t])[0], torch.arange(3.0))
    assert dt.host_local_slice(10) == slice(0, 10)
    with pytest.raises(ValueError, match="does not match 1 process"):
        dt.make_mesh((2,))
    with pytest.raises(ValueError, match="'data' axis"):
        dt.make_mesh((1,), ("model",))
    assert dt.make_mesh((1, 1), ("data", "model")).size == 1


def test_tensor_parallelism_raises_by_name():
    """Tensor parallelism is ported (A9): the placement names exist and run;
    what still raises by name is an axis the mesh does not have."""
    assert M.mlp_tp_specs(3) == ([(None, "model"), ("model", None), ()],
                                 [("model",), (), ()])
    chain = dt.flow_chain(dt.coupling_layer(
        2, [0], device="cpu", generator=torch.Generator().manual_seed(0)))
    placed = M.shard_params_tp(dt.make_mesh(), chain)
    assert placed is not chain and type(placed) is type(chain)
    with pytest.raises(ValueError, match="'data' and 'model'"):
        dt.make_mesh((1, 1), ("data", "pipeline"))
    two = dt.Mesh(None, 2, 0)
    assert two.shape == {"data": 2}


def test_a_model_axis_is_refused_as_tensor_parallelism(monkeypatch):
    """``make_mesh`` as a group of two ranks would see it: a ``model`` axis
    of size 2 is tensor parallelism over the group (A9, ported), laid out
    row-major as ``jax.make_mesh`` orders devices; the data axis then has
    one rank and no group."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    group = object()
    mesh = M.make_mesh(group=group)
    assert (mesh.size, mesh.rank) == (2, 1)
    dp = M.make_mesh((2, 1), ("data", "model"), group=group)
    assert (dp.size, dp.rank, dp.model_size) == (2, 1, 1)
    assert dp.shape == {"data": 2, "model": 1} and dp.group is group
    tp = M.make_mesh((1, 2), ("data", "model"), group=group)
    assert (tp.size, tp.rank, tp.group) == (1, 0, None)
    assert (tp.model_size, tp.model_rank) == (2, 1)
    assert tp.model_group is group and tp.world is group
    assert tp.shape == {"data": 1, "model": 2}
    assert dt.host_local_rows(tp, 10) == slice(0, 10)
    with pytest.raises(ValueError, match="does not match 2 process"):
        M.make_mesh((3,), group=group)


@pytest.mark.parametrize("n,size", [(64, 2), (10, 4), (3, 4), (7, 1)])
def test_host_local_rows_partition_a_batch(n, size):
    """The ranks' row ranges are contiguous, disjoint, in rank order, and
    cover every row (late ranks may hold fewer, or none)."""
    spans = [dt.host_local_rows(dt.Mesh(None, size, r), n)
             for r in range(size)]
    assert spans[0].start == 0 and spans[-1].stop == n
    for a, b in zip(spans, spans[1:]):
        assert a.stop == b.start
    rows = np.arange(n)
    parts = [dt.shard_batch(dt.Mesh(None, size, r), rows)
             for r in range(size)]
    np.testing.assert_array_equal(np.concatenate(parts), rows)
    x, m = dt.shard_batch(dt.Mesh(None, size, 0), torch.zeros(n, 2),
                          torch.ones(n))
    assert x.shape[0] == m.shape[0] == -(-n // size)


# -- one rank, a real group ------------------------------------------------------

def _flows(variant="reference"):
    jdata, tdata, x = cond_data()
    from _torch_parity import TRAIN_CHAINS

    chain = randomize(TRAIN_CHAINS[variant](jdata, x), 3)

    def build():
        jflow = df.Flow(chain, jdata)
        return jflow, torch_flow(jflow, tdata)

    return jdata, tdata, build


def test_mesh_collectives_run_through_the_group(group_mesh):
    mesh = group_mesh
    assert mesh.group is not None and (mesh.size, mesh.rank) == (1, 0)
    t = torch.arange(4.0)
    mesh.all_reduce_(t)
    mesh.broadcast_(t)
    mesh.barrier()
    assert torch.equal(t, torch.arange(4.0))
    assert dt.host_local_slice(9) == slice(0, 9)
    dt.distributed_init("file:///nonexistent/never-opened", 1, 0)  # joined


@pytest.mark.parametrize("path", ["fused-step-mesh", "torch"])
def test_train_on_a_mesh_equals_the_jax_package_on_its_mesh(group_mesh,
                                                            path):
    """``train(mesh=...)`` for 3 epochs against the JAX package's
    ``train(mesh=make_mesh())`` on its 8 virtual devices, same weights and
    batch order: histories 1e-4, parameters 1e-3. Both of the port's
    programs: the step kernel's (its plain version here) and the plain one."""
    jdata, tdata, build = _flows()
    jflow, tflow = build()
    key = jax.random.key(7)
    n_train = len(jdata.partition.training)
    df.train(jflow, jdata, df.adam(2e-3), epochs=3, batchsize=32,
             verbose=False, key=key, mesh=jax_make_mesh())
    state = dt.train(tflow, tdata, dt.adam(2e-3), epochs=3, batchsize=32,
                     verbose=False, mesh=group_mesh,
                     fused_kernel=path == "fused-step-mesh",
                     _epoch_perms=jax_epoch_perms(key, 3, n_train))
    assert tflow.trained_path == path
    np.testing.assert_allclose(tflow.train_loss, jflow.train_loss, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tflow.valid_loss, jflow.valid_loss, rtol=0,
                               atol=ATOL)
    assert_leaves_close(jflow.model, tflow.model, PARAM_ATOL)
    assert state.count == 3 * -(-n_train // 32)


def test_mesh_step_program_options_equal_the_plain_program(group_mesh):
    """Weights, the non-finite guard, best-epoch tracking and a resumed
    state on the step-kernel program against the single-device plain program
    (1e-4 histories, 1e-3 parameters); a NaN row is skipped on both."""
    jdata, tdata, build = _flows("actnorm")
    n_train = len(tdata.partition.training)
    perms = np.stack([np.random.default_rng(e).permutation(n_train)
                      for e in range(4)])
    w = np.random.default_rng(5).uniform(0.3, 2.0, size=tdata.x.shape[0])
    x_bad = np.array(tdata.x)
    x_bad[int(np.asarray(tdata.partition.training)[5]), 1] = np.nan
    bad = dt.DataArrays.make(x_bad, tdata.theta, rng=0)
    assert bad.partition.training.tolist() == \
        tdata.partition.training.tolist()
    runs = {}
    for name, kw in (("mesh", dict(mesh=group_mesh, fused_kernel=True)),
                     ("plain", dict(fused_kernel=False))):
        flow = build()[1]
        common = dict(batchsize=32, verbose=False, weights=w,
                      skip_nonfinite=True, **kw)
        state = dt.train(flow, bad, dt.adam(2e-3), epochs=2,
                         _epoch_perms=perms[:2], **common)
        state, best = dt.train(flow, bad, dt.adam(2e-3), state, epochs=2,
                               _epoch_perms=perms[2:], _track_best=True,
                               **common)
        runs[name] = (flow, state, best)
    (fm, sm, bm), (fp, sp_, bp) = runs["mesh"], runs["plain"]
    assert fm.trained_path == "fused-step-mesh" and fp.trained_path == "torch"
    assert fm.skipped_updates == fp.skipped_updates == [1, 1, 1, 1]
    assert sm.count == sp_.count == 4 * -(-n_train // 32) - 4
    for a, b in zip(list(fm.model.parameters()) + list(bm.parameters())
                    + sm.mu + sm.nu,
                    list(fp.model.parameters()) + list(bp.parameters())
                    + sp_.mu + sp_.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=PARAM_ATOL)


def test_mesh_routing_declines_and_forcing(group_mesh):
    jdata, tdata, build = _flows()
    flow = build()[1]
    kw = dict(epochs=1, batchsize=32, verbose=False, mesh=group_mesh)
    # a CPU flow never auto-routes to a kernel: the plain DP program
    dt.train(flow, tdata, **kw)
    assert flow.trained_path == "torch"
    assert flow.fused_decline_reason == "non-CUDA device (cpu)"
    assert FT.fused_step_mesh_reason(flow, 32, group_mesh) is None
    assert "not divisible" in FT.fused_step_mesh_reason(
        flow, 33, dt.Mesh(None, 2, 0))

    class OtherAdam(dt.Adam):
        pass

    with pytest.raises(ValueError, match="built-in Adam"):
        dt.train(flow, tdata, OtherAdam(), fused_kernel=True, **kw)
    with pytest.raises(ValueError, match="plain training surface"):
        dt.train(flow, tdata, fused_kernel=True, debug=True, **kw)
    with pytest.raises(UnsupportedFusedTrain, match="Adam state"):
        dt.train(flow, tdata, dt.adam(), object(), fused_kernel=True, **kw)
    # the envelope is the kernel's shared memory, by its exact bytes
    need = FT.fold_for_step(flow).step_plan.shared_bytes(1)
    old = SK.MAX_SHARED_BYTES
    SK.MAX_SHARED_BYTES = need - 4
    try:
        reason = FT.fused_step_reason(flow)
        assert f"{need} bytes of shared memory" in reason
        with pytest.raises(UnsupportedFusedTrain, match="shared memory"):
            dt.train(flow, tdata, fused_kernel=True, **kw)
    finally:
        SK.MAX_SHARED_BYTES = old
    # the chunked loops pass the mesh on
    n0 = len(flow.train_loss)
    dt.train(flow, tdata, epochs=12, batchsize=64, verbose=False,
             mesh=group_mesh, debug=True,
             generator=torch.Generator().manual_seed(0))
    assert len(flow.train_loss) == n0 + 12


def test_train_with_checkpoints_on_a_mesh(group_mesh, tmp_path):
    jdata, tdata, build = _flows()
    flow = build()[1]
    ckpt = str(tmp_path / "ckpt")
    state = dt.train(flow, tdata, epochs=4, batchsize=64, verbose=False,
                     mesh=group_mesh, checkpoint_dir=ckpt, checkpoint_every=2,
                     generator=torch.Generator().manual_seed(1))
    loaded, lstate = dt.load_flow(ckpt, dt.adam(), device="cpu")
    assert lstate.count == state.count and len(loaded.train_loss) == 4
    for a, b in zip(loaded.model.parameters(), flow.model.parameters()):
        assert torch.equal(a, b)


def test_train_streaming_on_a_mesh_equals_no_mesh(group_mesh):
    """One rank: the mesh only adds collectives over one rank, so plain and
    step-kernel streaming equal their runs without a mesh (1e-6)."""
    x, th, _data, build, _perms = W.build_case()
    for fused, path in ((True, "fused-step-mesh"), (False, "torch")):
        a = W.stream(group_mesh, x, th, build, fused)
        b = W.stream(None, x, th, build, fused)
        assert a["path"] == path and a["count"] == b["count"]
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(a["valid_loss"], b["valid_loss"],
                                   rtol=0, atol=1e-6)


# -- two ranks in two processes --------------------------------------------------

def _run_ranks(tmp_path, world=2, timeout=240):
    init = tmp_path / "rendezvous"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, _TESTS, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_TESTS, "_torch_distributed_worker.py"),
         str(r), str(world), str(init), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_REPO) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append(out[-2000:] + err[-4000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[1][-4000:] for p in procs]
        pytest.fail("a rank did not finish in time:\n" + "\n---\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    results = []
    for r in range(world):
        with open(tmp_path / f"result_{r}.json") as f:
            results.append(json.load(f))
    return results


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol)


def test_two_ranks_equal_one_process(tmp_path):
    """Two gloo ranks, each on half of every batch, against one process:
    ``make_fused_step_fn`` batch for batch (losses 1e-4, parameters 1e-4
    after six steps), ``train(mesh=...)`` on both programs (histories 1e-4,
    parameters 1e-3), and ``train_streaming(mesh=...)`` with one loader shard
    per rank against one process stepping on the shards' batches joined
    (histories 1e-4, parameters 1e-3). Both ranks end with the same bits."""
    ranks = _run_ranks(tmp_path)
    ref = W.single_process_reference()
    for key in ("step_losses", "step_params", "train_fused", "train_plain",
                "stream_fused", "stream_plain"):
        assert ranks[0][key] == ranks[1][key], key
    assert ranks[0]["replicated"] == ranks[1]["replicated"] == [0.0] * 3
    got = ranks[0]

    _close(got["step_losses"], ref["step_losses"], ATOL)
    _close(got["step_params"], ref["step_params"], ATOL)
    assert got["step_count"] == ref["step_count"] == 6

    want = ref["train_plain"]
    for name, path in (("train_fused", "fused-step-mesh"),
                       ("train_plain", "torch")):
        run = got[name]
        assert run["path"] == path and run["count"] == want["count"]
        _close(run["train_loss"], want["train_loss"], ATOL)
        _close(run["valid_loss"], want["valid_loss"], ATOL)
        for a, b in zip(run["leaves"], want["leaves"]):
            _close(a, b, PARAM_ATOL)

    want = ref["stream"]
    for name, path in (("stream_fused", "fused-step-mesh"),
                       ("stream_plain", "torch")):
        run = got[name]
        assert run["path"] == path and run["count"] == want["count"]
        _close(run["train_loss"], want["train_loss"], ATOL)
        for a, b in zip(run["leaves"], want["leaves"]):
            _close(a, b, PARAM_ATOL)
    # the validation NLL is the final model's own on both step kinds
    _close(got["stream_fused"]["valid_loss"],
           got["stream_plain"]["valid_loss"], ATOL)
