"""Sharded checkpoints of the port on the CPU (``utils/orbax_ckpt.py`` on
``torch.distributed.checkpoint``): a round trip in one process of the flow of
JAX ``tests/test_checkpoint.py::test_orbax_flow_roundtrip``, held against the
JAX package's ``save_flow_orbax``; and on two gloo ranks in two processes
(``_torch_mesh2d_worker.py``, mode ``ckpt``) a chain trained
tensor-parallel on a (1, 2) ("data", "model") mesh, saved with its Adam
state, each rank writing only its shards, then read back in one process,
onto the (1, 2) mesh and onto a (2, 1) mesh; on four ranks (mode
``ckpt22``) the same on a (2, 2) mesh.

Tolerances: a checkpoint stores the bits, so the port against itself is bit
for bit, but for ``log_prob(mesh=)`` on the (2, 1) mesh, held to one process
at 1e-6 as in ``test_torch_mesh_serving.py`` (each rank multiplies half the
rows, which the CPU's products may block differently); the port's
``log_prob`` against JAX's at 1e-5 (the same f32 products summed in another
order).
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
from densityflows_tpu_torch.parallel import mesh as M
from densityflows_tpu_torch.utils.checkpoint import (
    _leaf_key,
    _leaf_shard_dims,
    adam_state_to_leaves,
    element_leaves,
    element_spec,
)
from densityflows_tpu_torch.utils.orbax_ckpt import (
    FORMAT,
    _stored_chunks,
    load_flow_orbax,
    save_flow_orbax,
)

import _torch_cpu  # noqa: F401
from _torch_mesh2d_worker import CK_BATCH, CK_MORE, CK_STEPS, run_ranks

D, N = 4, 1


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def tensor_bits(t) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# -- one process, against the JAX package -------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """JAX ``test_orbax_flow_roundtrip``'s flow trained 2 epochs with its
    Adam state, the port's flow and state carried across, and the rows."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    th = rng.uniform(size=(256, 1)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    chain = df.flow_chain(
        df.coupling_layer(data, [0, 1], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0))
    jflow = df.Flow(chain, data)
    jstate = df.train(jflow, data, optax.adam(1e-3), epochs=2, verbose=False,
                      key=jax.random.key(1))
    tflow = dt.flow_from_jax_numpy(
        jax_spec(jflow.model), _leaves(jflow.model), jax_spec(jflow.base),
        _leaves(jflow.base), jflow.metadata, "cpu",
        train_loss=jflow.train_loss, valid_loss=jflow.valid_loss)
    tstate = dt.adam_state_from_jax_leaves(tflow.model, _leaves(jstate))
    return jflow, jstate, tflow, tstate, x[:32], th[:32]


def test_round_trip_of_the_jax_suites_flow(jax_run, tmp_path):
    """(a) The flow of JAX ``test_orbax_flow_roundtrip``, carried across:
    after a round trip in one process ``log_prob`` is bit for bit the
    port's before saving and within 1e-5 of JAX's; the Adam leaves (JAX's
    too) and the loss histories are equal."""
    jflow, jstate, tflow, tstate, x, th = jax_run
    path = str(tmp_path / "ckpt")
    save_flow_orbax(path, tflow, tstate)
    assert sorted(os.listdir(path)) == ["base", "flow.json", "model",
                                        "opt_state"]
    flow2, state2 = load_flow_orbax(path, dt.adam(1e-3), device="cpu")
    with torch.no_grad():
        lp, lp2 = tflow.log_prob(x, th), flow2.log_prob(x, th)
    assert same_bits(lp.numpy(), lp2.numpy())
    np.testing.assert_allclose(lp2.numpy(), np.asarray(jflow.log_prob(x, th)),
                               rtol=0, atol=1e-5)
    assert flow2.train_loss == tflow.train_loss == list(jflow.train_loss)
    assert flow2.valid_loss == tflow.valid_loss
    assert isinstance(state2.count, int) and state2.count == tstate.count
    got = adam_state_to_leaves(flow2.model, state2)
    for a, b, c in zip(got, adam_state_to_leaves(tflow.model, tstate),
                       _leaves(jstate)):
        assert same_bits(a, b)
        np.testing.assert_array_equal(a, c)
    # without an optimizer the flow alone comes back
    assert isinstance(load_flow_orbax(path, device="cpu"), dt.Flow)


@pytest.fixture(scope="module")
def jax_dir(jax_run, tmp_path_factory):
    """The JAX package's ``save_flow_orbax`` directory of that flow."""
    orbax_ckpt = pytest.importorskip("densityflows_tpu.utils.orbax_ckpt")
    pytest.importorskip("orbax.checkpoint")
    jflow, jstate = jax_run[:2]
    path = str(tmp_path_factory.mktemp("jax_orbax") / "ckpt")
    orbax_ckpt.save_flow_orbax(path, jflow, jstate)
    return path


def test_flow_json_is_the_jax_packages_but_the_format(jax_run, jax_dir,
                                                      tmp_path):
    """(b) Every key of ``flow.json`` but ``"format"`` equals what JAX
    ``save_flow_orbax`` writes for the same flow, and the directory holds
    the same three stores."""
    _, _, tflow, tstate, _, _ = jax_run
    path = str(tmp_path / "ckpt")
    save_flow_orbax(path, tflow, tstate)
    metas = []
    for folder in (jax_dir, path):
        with open(os.path.join(folder, "flow.json")) as f:
            metas.append(json.load(f))
    jmeta, tmeta = metas
    assert jmeta.pop("format") == "orbax" and tmeta.pop("format") == FORMAT
    assert tmeta == jmeta
    assert sorted(os.listdir(jax_dir)) == sorted(os.listdir(path))


def test_a_jax_orbax_directory_raises_by_name(jax_run, jax_dir, tmp_path):
    """(g) The port does not read tensorstore: a JAX Orbax directory raises
    a ValueError that names the way across; an npz checkpoint names
    ``load_flow``."""
    with pytest.raises(ValueError, match="save_flow_orbax") as e:
        load_flow_orbax(jax_dir, device="cpu")
    for name in ("densityflows_tpu.utils.orbax_ckpt.load_flow_orbax",
                 "densityflows_tpu.save_flow", "load_flow"):
        assert name in str(e.value)
    dt.save_flow(str(tmp_path / "npz"), jax_run[2])
    with pytest.raises(ValueError, match="loads with load_flow"):
        load_flow_orbax(str(tmp_path / "npz"), device="cpu")


def test_bfloat16_conditioners_round_trip_bit_for_bit(tmp_path):
    """(f) A chain whose conditioners are stored in bfloat16
    (``cast_conditioners``), trained one epoch: leaves, moments and
    ``log_prob`` come back bit for bit with their dtypes; the count is an
    int."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(96, D)).astype(np.float32)
    th = rng.uniform(size=(96, N)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    g = torch.Generator().manual_seed(4)
    chain = dt.cast_conditioners(dt.flow_chain(
        dt.coupling_block(data, None, generator=g, hidden_dim_s=8,
                          hidden_dim_t=8, device="cpu"),
        dt.normalization_layer(x, -1.0, 1.0, device="cpu")))
    flow = dt.Flow(chain, data, device="cpu")
    state = dt.train(flow, data, dt.adam(1e-3), epochs=1, batchsize=32,
                     verbose=False, fused_kernel=False,
                     generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "bf16")
    save_flow_orbax(path, flow, state)
    flow2, state2 = load_flow_orbax(path, dt.adam(1e-3), device="cpu")
    leaves, leaves2 = element_leaves(flow.model), element_leaves(flow2.model)
    assert sum(t.dtype == torch.bfloat16 for t in leaves) > 0
    for a, b in zip(leaves + state.mu + state.nu,
                    leaves2 + state2.mu + state2.nu):
        assert a.dtype == b.dtype and same_bits(tensor_bits(a),
                                                tensor_bits(b))
    assert isinstance(state2.count, int) and state2.count == state.count
    with torch.no_grad():
        assert same_bits(flow.log_prob(x, th).numpy(),
                         flow2.log_prob(x, th).numpy())


def _fake_model_axis(rank, size=2):
    """A mesh whose model axis has ``size`` ranks but no group: placement
    without collectives."""
    return M.Mesh(None, 1, 0, model_size=size, model_rank=rank,
                  axis_names=("data", "model"))


def port_chain():
    """A coupling block of hidden 16 (its layer pairs split over two ranks),
    a coupling of hidden 9 (which two ranks do not divide: it stays
    replicated) and a normalization layer (buffers: zero moments)."""
    g = torch.Generator().manual_seed(0)
    x_ref = np.random.default_rng(2).normal(size=(64, D)).astype(np.float32)
    kw = dict(n=N, generator=g, zero_init_final=False, device="cpu")
    return dt.flow_chain(
        dt.coupling_block(D, None, hidden_dim_s=16, hidden_dim_t=16, **kw),
        dt.coupling_layer(D, [0, 1], hidden_dim_s=9, hidden_dim_t=9, **kw),
        dt.normalization_layer(x_ref, -1.0, 1.0, device="cpu"))


def test_a_tensor_parallel_chain_has_the_replicated_chains_spec(tmp_path):
    """A ``TensorParallelMLP``'s spec is the one of the MLP it places, so the
    sharded format writes the replicated chain's specs; the npz element
    format refuses one rank's shards."""
    chain = port_chain()
    for rank in (0, 1):
        tp = M.shard_params_tp(_fake_model_axis(rank), chain)
        assert element_spec(tp) == element_spec(chain)
        with pytest.raises(TypeError, match="save_flow_orbax"):
            dt.save_element(str(tmp_path / f"el{rank}"), tp)


# -- two ranks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks of the worker's ``ckpt`` mode, its folder and the flow it
    started from (also saved by ``save_flow_orbax`` in this process)."""
    folder = str(tmp_path_factory.mktemp("ckpt"))
    flow = dt.Flow(port_chain(), dt.MetaData("", D, N, np.zeros(N),
                                             np.ones(N)), device="cpu")
    dt.save_flow(os.path.join(folder, "flow"), flow)
    save_flow_orbax(os.path.join(folder, "rep_ckpt"), flow)
    rng = np.random.default_rng(1)
    rows = (CK_STEPS + CK_MORE) * CK_BATCH
    np.savez(os.path.join(folder, "ckpt_batch.npz"),
             x=rng.normal(size=(rows, D)).astype(np.float32),
             th=rng.uniform(size=(rows, N)).astype(np.float32),
             xe=rng.normal(size=(101, D)).astype(np.float32),
             the=rng.uniform(size=(101, N)).astype(np.float32))
    return run_ranks("ckpt", folder), folder, flow


def test_each_rank_file_holds_only_its_shards(two_ranks):
    """(c) DCP's metadata of the (1, 2) checkpoint: every sharded leaf and
    both its moments are two chunks, rank m's in rank m's file; no file
    holds a whole sharded tensor; each replicated tensor is one chunk."""
    _, folder, flow = two_ranks
    leaves = element_leaves(flow.model)
    dims = _leaf_shard_dims(M.shard_params_tp(_fake_model_axis(0),
                                              flow.model))
    assert sum(dm is not None for dm in dims) == 12
    for store, prefixes in (("model", ("",)), ("opt_state", ("mu/", "nu/"))):
        path = os.path.join(folder, "tp_ckpt", store)
        assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp",
                                            "__1_0.distcp"]
        chunks = _stored_chunks(path)
        for prefix in prefixes:
            for i, (t, dm) in enumerate(zip(leaves, dims)):
                got = sorted(chunks[prefix + _leaf_key(i)])
                full = tuple(t.shape)
                if dm is None:
                    assert len(got) == 1 and got[0][:2] == (
                        (0,) * len(full), full), (store, prefix, i)
                    continue
                dim, step = dm[1], full[dm[1]] // 2
                want = []
                for m in range(2):
                    off, size = [0] * len(full), list(full)
                    off[dim], size[dim] = m * step, step
                    want.append((tuple(off), tuple(size), f"__{m}_0.distcp"))
                assert got == want, (store, prefix, i)
        if store == "opt_state":
            assert len(chunks["count"]) == 1


def test_the_checkpoint_loads_in_one_process_as_the_gathered_chain(two_ranks):
    """(d) In one process the (1, 2) checkpoint is, leaf for leaf and
    moment for moment, ``_gather_tp`` of the saved chain and state, with
    the replicated chain's specs and the histories."""
    ranks, folder, flow = two_ranks
    r0 = ranks[0]
    loaded, state = load_flow_orbax(os.path.join(folder, "tp_ckpt"),
                                    dt.adam(1e-3), device="cpu")
    assert element_spec(loaded.model) == element_spec(flow.model)
    for i, t in enumerate(element_leaves(loaded.model)):
        assert same_bits(tensor_bits(t), r0[f"gathered_{i}"]), i
    for i, a in enumerate(adam_state_to_leaves(loaded.model, state)):
        assert same_bits(a, r0[f"gathered_adam_{i}"]), i
    assert state.count == CK_STEPS
    assert loaded.train_loss == list(r0["uninterrupted_losses"][:CK_STEPS])


def test_onto_the_same_mesh_each_rank_resumes_bit_for_bit(two_ranks):
    """(d) Onto the (1, 2) mesh every rank gets back its own shards and
    moments, and the replicated leaves it saved, bit for bit, with the same
    placement (the pair of hidden 9 replicated); 2 more steps equal the run
    that went on without the checkpoint, losses and shards."""
    ranks, _, flow = two_ranks
    n = len(element_leaves(flow.model))
    n_train = sum(1 for k in ranks[0] if k.startswith("saved_mu_"))
    for r in ranks:
        for i in range(n):
            assert same_bits(r[f"loaded_{i}"], r[f"saved_{i}"]), i
            assert same_bits(r[f"resumed_{i}"], r[f"uninterrupted_{i}"]), i
        for i in range(n_train):
            assert same_bits(r[f"loaded_mu_{i}"], r[f"saved_mu_{i}"]), i
            assert same_bits(r[f"loaded_nu_{i}"], r[f"saved_nu_{i}"]), i
        assert int(r["loaded_count"]) == CK_STEPS
        saved_specs, loaded_specs = json.loads(str(r["specs"]))
        assert loaded_specs == saved_specs and len(saved_specs) == 6
        assert [s[0][0] for s in saved_specs][-2:] == [[], []]
        assert same_bits(r["resumed_losses"], r["uninterrupted_losses"])
        assert r["resumed_losses"].shape == (CK_STEPS + CK_MORE,)
    assert same_bits(ranks[0]["loaded_train_loss"],
                     ranks[0]["uninterrupted_losses"][:CK_STEPS])
    # the ranks hold different halves of a split leaf
    assert not same_bits(ranks[0]["saved_0"], ranks[1]["saved_0"])


def test_onto_a_data_mesh_every_rank_loads_the_replicated_chain(two_ranks):
    """(d) Onto a (2, 1) mesh every rank reads the whole replicated chain,
    bit for bit the one-process load, and ``log_prob(mesh=)`` of 101 rows
    equals the one-process call (1e-6)."""
    ranks, folder, _ = two_ranks
    one = load_flow_orbax(os.path.join(folder, "tp_ckpt"), device="cpu")
    b = np.load(os.path.join(folder, "ckpt_batch.npz"))
    with torch.no_grad():
        lp = one.log_prob(b["xe"], b["the"]).numpy()
    for r in ranks:
        for i, t in enumerate(element_leaves(one.model)):
            assert same_bits(r[f"leaves_2x1_{i}"], tensor_bits(t)), i
        np.testing.assert_allclose(r["lp_2x1"], lp, rtol=1e-6, atol=1e-6)


def test_a_one_process_checkpoint_loads_onto_a_model_axis(two_ranks):
    """(e) A checkpoint written in one process, loaded onto the (1, 2)
    mesh, is ``shard_params_tp`` of the chain: the same shards, leaf for
    leaf, and the same placement, the pair of hidden 9 replicated."""
    ranks, _, flow = two_ranks
    n = len(element_leaves(flow.model))
    for r in ranks:
        for i in range(n):
            assert same_bits(r[f"onto_{i}"], r[f"placed_{i}"]), i
        onto, placed = json.loads(str(r["onto_specs"]))
        assert onto == placed and len(onto) == 6
        assert [s[0][0] for s in onto] == [[None, "model"]] * 4 + [[]] * 2
    assert not same_bits(ranks[0]["onto_0"], ranks[1]["onto_0"])


@pytest.fixture(scope="module")
def four_ranks(two_ranks):
    """The worker's ``ckpt22`` mode on four ranks, in the folder of the
    two-rank run (its flow and rows)."""
    _, folder, flow = two_ranks
    return run_ranks("ckpt22", folder, world=4), folder, flow


def test_a_2x2_mesh_saves_each_shard_once_and_loads_it_back(four_ranks):
    """On a (2, 2) mesh both data rows hold every shard: DCP writes each
    chunk once (two chunks per sharded tensor, in the files of the ranks of
    one data row); onto the same mesh every rank gets back its shards,
    moments and replicated leaves bit for bit; in one process the
    checkpoint is ``_gather_tp`` of the chain and state."""
    ranks, folder, flow = four_ranks
    n = len(element_leaves(flow.model))
    n_moments = sum(1 for k in ranks[0] if k.startswith("saved_mu_"))
    for r in ranks:
        for i in range(n):
            assert same_bits(r[f"loaded_{i}"], r[f"saved_{i}"]), i
        for i in range(n_moments):
            assert same_bits(r[f"loaded_mu_{i}"], r[f"saved_mu_{i}"]), i
    # the data rows hold the same shards; the model columns differ
    by_place = {tuple(r["place"]): r for r in ranks}
    assert same_bits(by_place[0, 0]["saved_0"], by_place[1, 0]["saved_0"])
    assert not same_bits(by_place[0, 0]["saved_0"], by_place[0, 1]["saved_0"])
    path = os.path.join(folder, "ckpt_2x2")
    dims = _leaf_shard_dims(M.shard_params_tp(_fake_model_axis(0),
                                              flow.model))
    chunks = _stored_chunks(os.path.join(path, "model"))
    for i, dm in enumerate(dims):
        assert len(chunks[_leaf_key(i)]) == (1 if dm is None else 2), i
    loaded, state = load_flow_orbax(path, dt.adam(1e-3), device="cpu")
    for i, t in enumerate(element_leaves(loaded.model)):
        assert same_bits(tensor_bits(t), ranks[0][f"gathered_{i}"]), i
    for i, a in enumerate(adam_state_to_leaves(loaded.model, state)):
        assert same_bits(a, ranks[0][f"gathered_adam_{i}"]), i
