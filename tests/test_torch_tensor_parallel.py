"""Tensor parallelism of the port on the CPU: the Megatron placement
(``parallel.mesh.mlp_tp_specs``, ``shard_params_tp``,
``ops.mlp.TensorParallelMLP``), against the JAX package's placement on its
virtual ``(4, 2)`` ("data", "model") mesh, and on two gloo ranks in two
processes (``_torch_mesh2d_worker.py``, mode ``tp``) against the replicated
chain in one process.

Tolerances: the losses of the tensor-parallel step against the replicated
one at rtol 1e-5 (the tolerance of JAX ``test_tp_training_matches_replicated``:
the same f32 products, the row-parallel ones summed over the two ranks in
another order); the port's loss against JAX's at 1e-5; parameters after one
step and after two epochs of Adam at 1e-4 / 1e-3 absolute; the histories at
1e-5 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.parallel.mesh import (
    data_sharding,
    make_mesh as jax_make_mesh,
    mlp_tp_specs as jax_mlp_tp_specs,
    replicated,
    shard_params_tp as jax_shard_params_tp,
)
from densityflows_tpu.train import make_train_step as jax_make_train_step
from densityflows_tpu_torch.models import fused_chain as FC
from densityflows_tpu_torch.ops.mlp import MLP, TensorParallelMLP
from densityflows_tpu_torch.parallel import mesh as M

from _torch_mesh2d_worker import TP_BATCH, TP_EPOCHS, run_ranks
from _torch_parity import randomize, to_torch

D, N, HIDDEN, BATCH = 4, 1, 16, 32


def jax_chain():
    return randomize(df.flow_chain(df.coupling_block(
        D, None, n=N, key=jax.random.key(0), hidden_dim_s=HIDDEN,
        hidden_dim_t=HIDDEN)), 5)


def batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(BATCH, D)).astype(np.float32),
            rng.uniform(size=(BATCH, N)).astype(np.float32),
            np.ones((BATCH,), np.float32))


@pytest.mark.parametrize("n_weights", [1, 2, 3, 4, 5])
def test_mlp_tp_specs_match_jax(n_weights):
    w, b = M.mlp_tp_specs(n_weights)
    jw, jb = jax_mlp_tp_specs(n_weights)
    assert w == [tuple(s) for s in jw] and b == [tuple(s) for s in jb]


def _fake_model_axis(rank, size=2):
    """A mesh whose model axis has ``size`` ranks but no group: placement
    and gathering of one rank's shards without collectives."""
    return M.Mesh(None, 1, 0, model_size=size, model_rank=rank,
                  axis_names=("data", "model"))


def test_placement_shards_pairs_and_keeps_a_non_dividing_width():
    g = torch.Generator().manual_seed(0)
    even = dt.init_mlp(g, 3, 5, 2, hidden_dim=8, device="cpu")
    odd = dt.init_mlp(g, 3, 5, 2, hidden_dim=9, device="cpu")
    for rank in (0, 1):
        tp = TensorParallelMLP.shard(even, _fake_model_axis(rank))
        assert tp.weight_specs == ((None, "model"), ("model", None), ())
        assert [tuple(w.shape) for w in tp.weights] == [(3, 4), (4, 8),
                                                        (8, 5)]
        assert [tuple(b.shape) for b in tp.biases] == [(4,), (8,), (5,)]
        assert tp.dims == even.dims and tp.shard_dims() == [1, 0, None,
                                                            0, None, None]
        np.testing.assert_array_equal(
            tp.weights[0].detach(), even.weights[0].detach()[:, 4 * rank:
                                                              4 * rank + 4])
        np.testing.assert_array_equal(
            tp.weights[1].detach(), even.weights[1].detach()[4 * rank:
                                                             4 * rank + 4])
        # hidden 9 does not split over 2 ranks: the pair stays replicated
        rep = TensorParallelMLP.shard(odd, _fake_model_axis(rank))
        assert rep.weight_specs == ((), (), ()) and rep.bias_specs == (
            (), (), ())
        for a, b in zip(list(rep.weights) + list(rep.biases),
                        list(odd.weights) + list(odd.biases)):
            assert torch.equal(a.detach(), b.detach())
        # without a group its model axis holds one rank's shards only, so
        # applying it needs the group: the replicated pair applies as is
        x = torch.randn(6, 3, generator=g)
        torch.testing.assert_close(dt.apply_mlp(rep, x), dt.apply_mlp(odd, x),
                                   rtol=0, atol=0)


def test_model_axis_of_one_is_the_replicated_chain():
    """``shard_params_tp`` on a mesh without a model axis larger than 1 is a
    copy of the replicated chain, which the chain kernel route takes."""
    chain = to_torch(jax_chain())
    for mesh in (dt.make_mesh(), dt.make_mesh((1, 1), ("data", "model"))):
        placed = M.shard_params_tp(mesh, chain)
        assert placed is not chain
        assert not any(isinstance(m, TensorParallelMLP)
                       for m in placed.modules())
        assert FC.chain_is_fusable(placed, D, N)
    tp = M.shard_params_tp(_fake_model_axis(0), chain)
    nets = [m for m in tp.modules() if isinstance(m, TensorParallelMLP)]
    assert len(nets) == 4 and not any(type(m) is MLP for m in tp.modules())
    assert not FC.chain_is_fusable(tp, D, N)


def test_tp_loss_of_the_jax_package_on_its_2d_mesh():
    """The reference: JAX's Megatron placement on the virtual (4, 2) mesh
    gives the replicated loss (JAX ``test_tp_training_matches_replicated``),
    and the port's replicated step gives the same loss on the same weights
    and batch."""
    chain = jax_chain()
    x, th, mask = batch()
    mesh2d = jax_make_mesh((4, 2), ("data", "model"))
    opt = optax.adam(1e-3)
    base = df.StandardNormal(D)

    def run(place):
        model = place(jax.tree_util.tree_map(jnp.array, chain))
        state = jax.device_put(opt.init(model), replicated(mesh2d))
        step = jax_make_train_step(opt)
        _, _, loss = step(model, state, base,
                          jax.device_put(x, data_sharding(mesh2d, 2)),
                          jax.device_put(th, data_sharding(mesh2d, 2)),
                          jax.device_put(mask, data_sharding(mesh2d, 1)))
        return float(loss)

    loss_tp = run(lambda m: jax_shard_params_tp(mesh2d, m))
    loss_rep = run(lambda m: jax.device_put(m, replicated(mesh2d)))
    np.testing.assert_allclose(loss_tp, loss_rep, rtol=1e-5)
    tchain = to_torch(chain)
    step = dt.make_train_step(dt.adam(1e-3))
    state = dt.adam(1e-3).init(
        [p for p in tchain.parameters() if p.requires_grad])
    _, _, loss = step(tchain, state, dt.StandardNormal(D), torch.as_tensor(x),
                      torch.as_tensor(th), torch.as_tensor(mask))
    np.testing.assert_allclose(float(loss), loss_tp, rtol=1e-5)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks of the worker's ``tp`` mode, its folder, and the JAX
    step's loss on the (4, 2) mesh for the same weights and batch."""
    folder = str(tmp_path_factory.mktemp("tp"))
    chain = jax_chain()
    x, th, mask = batch()
    rng = np.random.default_rng(1)
    x_all = rng.normal(size=(200, D)).astype(np.float32)
    th_all = rng.uniform(size=(200, N)).astype(np.float32)
    data = dt.DataArrays.make(x_all, th_all, rng=0)
    n_train = len(data.partition.training)
    perms = np.stack([np.random.default_rng(10 + e).permutation(n_train)
                      for e in range(TP_EPOCHS)])
    flow = dt.Flow(to_torch(chain), data, device="cpu")
    dt.save_flow(os.path.join(folder, "flow"), flow)
    np.savez(os.path.join(folder, "batch.npz"), x=x, th=th, mask=mask,
             x_all=x_all, th_all=th_all, perms=perms)

    mesh2d = jax_make_mesh((4, 2), ("data", "model"))
    opt = optax.adam(1e-3)
    model = jax_shard_params_tp(mesh2d,
                                jax.tree_util.tree_map(jnp.array, chain))
    state = jax.device_put(opt.init(model), replicated(mesh2d))
    _, _, loss = jax_make_train_step(opt)(
        model, state, df.StandardNormal(D),
        jax.device_put(x, data_sharding(mesh2d, 2)),
        jax.device_put(th, data_sharding(mesh2d, 2)),
        jax.device_put(mask, data_sharding(mesh2d, 1)))
    return run_ranks("tp", folder), folder, float(loss), data


def test_tp_step_on_two_ranks_equals_the_replicated_chain(two_ranks):
    """``make_train_step`` on a (1, 2) mesh with the chain placed by
    ``shard_params_tp``: two steps' losses equal the replicated chain's at
    rtol 1e-5 and JAX's (4, 2) loss at 1e-5; the gathered parameters after
    the steps equal the replicated ones at 1e-4. Both ranks agree."""
    ranks, _, jax_loss, _ = two_ranks
    r0, r1 = ranks
    for key in ("step_loss_tp", "step_params_tp"):
        np.testing.assert_array_equal(r0[key], r1[key])
    np.testing.assert_allclose(r0["step_loss_tp"], r0["step_loss_rep"],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["step_loss_tp"][0], jax_loss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r0["step_params_tp"], r0["step_params_rep"],
                               rtol=0, atol=1e-4)
    # each rank holds half of every sharded pair
    assert r0["shard_shapes"].sum() < r0["step_params_rep"].size


def test_train_on_a_model_axis_declines_the_step_kernel(two_ranks):
    """``train(mesh=...)`` on the (1, 2) mesh runs the plain program with
    the step kernel's decline in ``flow.fused_decline_reason`` (JAX's
    reason), ``fused_kernel=True`` raises it, and the histories and
    parameters equal the replicated run's; on a (2, 1) mesh the step kernel
    applies."""
    ranks, _, _, _ = two_ranks
    r0 = ranks[0]
    info = json.loads(str(r0["info"]))
    assert info == json.loads(str(ranks[1]["info"]))
    assert info["path"] == "torch"
    assert "non-DP mesh axes (fused-step DP shards 'data' only)" in \
        info["reason"]
    assert info["forced"] == "non-DP mesh axes (fused-step DP shards " \
        "'data' only)"
    assert info["reason_2x1"] is None and info["path_2x1"] == \
        "fused-step-mesh"
    np.testing.assert_allclose(r0["train_tp"], r0["train_rep"], rtol=1e-5)
    np.testing.assert_allclose(r0["train_params_tp"], r0["train_params_rep"],
                               rtol=0, atol=1e-3)


def test_train_streaming_on_a_model_axis_keeps_each_ranks_shards(two_ranks):
    """``train_streaming(mesh=...)`` on the (1, 2) mesh: each rank trains
    its own column and row shards (none is overwritten by rank 0's), so the
    histories and the gathered parameters equal the replicated run's; a
    forced step kernel raises JAX's reason."""
    ranks, _, _, _ = two_ranks
    r0, r1 = ranks
    np.testing.assert_array_equal(r0["stream_tp"], r1["stream_tp"])
    np.testing.assert_allclose(r0["stream_tp"], r0["stream_rep"], rtol=1e-5)
    np.testing.assert_allclose(r0["stream_params_tp"],
                               r0["stream_params_rep"], rtol=0, atol=1e-3)
    info = json.loads(str(r0["info"]))
    assert "non-DP mesh axes (fused-step DP shards 'data' only)" in \
        info["stream_forced"]


def test_save_flow_of_a_tp_chain_writes_the_replicated_bytes(two_ranks):
    """The shards are gathered over the model axis: the arrays and specs on
    disk are the replicated chain's, byte for byte; a trained run saved with
    its Adam state loads as a replicated flow with the gathered
    parameters."""
    ranks, folder, _, data = two_ranks
    for part in ("model", "base"):
        for name in ("spec.json", "arrays.npz"):
            with open(os.path.join(folder, "tp_saved", part, name),
                      "rb") as f:
                got = f.read()
            with open(os.path.join(folder, "rep_saved", part, name),
                      "rb") as f:
                want = f.read()
            assert got == want, (part, name)
    flow, state = dt.load_flow(os.path.join(folder, "tp_trained"),
                               dt.adam(1e-3), device="cpu")
    got = np.concatenate([p.detach().reshape(-1).numpy()
                          for p in flow.model.parameters()
                          if p.requires_grad])
    np.testing.assert_array_equal(got, ranks[0]["train_params_tp"])
    assert state.count == TP_EPOCHS * -(-len(data.partition.training)
                                        // TP_BATCH)
    assert [tuple(m.shape) for m in state.mu] == [
        tuple(p.shape) for p in flow.model.parameters() if p.requires_grad]
