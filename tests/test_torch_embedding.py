"""The port's condition embedding (``models/embedding.py``) against the JAX
package on the CPU: ``EmbeddedChain``'s directions, a flow's ``log_prob`` and
``sample`` and their routes (sampling runs the inner chain on
``chain_apply``, density evaluation stays per-layer, as in JAX), 2 epochs of
``train()`` with the JAX batch order (the embedding trained too), the
whole-run kernel's decline by name, and checkpoints with their Adam state in
both directions (embedding leaves first, then the chain's).

Tolerance: ``TOL`` (2e-5) for one pass; ``TRAIN_ATOL`` (1e-4) for 2 epochs
(float accumulation order through Adam, the JAX suite's own bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.models.fused_train import trainable_leaves

from _torch_parity import (
    TOL, TRAIN_ATOL, assert_leaves_close, assert_opt_state_close, fake_cuda,
    jax_epoch_perms, randomize, t, to_torch)

D, N_RAW, E = 4, 6, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(120, D)).astype(np.float32)
    th = rng.uniform(-1, 1, size=(120, N_RAW)).astype(np.float32)
    x[:, 0] += th[:, 0] + 0.5 * th[:, 3]
    return df.DataArrays.make(x, th, rng=0), dt.DataArrays.make(x, th, rng=0)


def jax_embedded(x, seed=0):
    ks = jax.random.split(jax.random.key(seed), 4)
    chain = df.flow_chain(
        df.coupling_block(D, None, n=E, key=ks[0], hidden_dim_s=12,
                          hidden_dim_t=12),
        df.coupling_layer(D, [0, 1], n=E, key=ks[1], hidden_dim_s=12,
                          hidden_dim_t=12),
        df.normalization_layer(x, -1.0, 1.0))
    return df.embed_conditions(chain, N_RAW, E, key=ks[2], hidden_dim=10)


def test_directions_equal_jax(data):
    jd, _ = data
    jm = randomize(jax_embedded(np.asarray(jd.x)), 3)
    tm = to_torch(jm)
    assert isinstance(tm, dt.EmbeddedChain) and len(tm) == len(jm) == 3
    assert tm.embed.dims == jm.embed.dims == (N_RAW, 10, 10, E)
    assert tm.summarize() == jm.summarize()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, D)).astype(np.float32)
    th = rng.uniform(size=(50, N_RAW)).astype(np.float32)
    for dirn in ("forward", "inverse"):
        got = getattr(tm, dirn)(t(x), t(th))
        want = jax.jit(getattr(jm, dirn))(x, th)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)
    np.testing.assert_allclose(
        tm.forward_(t(x), t(th)).detach().numpy(),
        np.asarray(jax.jit(jm.forward_)(x, th)), **TOL)
    g = torch.Generator().manual_seed(0)
    built = dt.embed_conditions(dt.flow_chain(dt.coupling_layer(
        D, 2, n=E, generator=g, device="cpu")), N_RAW, E, generator=g,
        device="cpu", n_sublayers=3, hidden_dim=7, activation="tanh")
    assert built.embed.dims == (N_RAW, 7, 7, 7, E)
    assert built.embed.activation == "tanh"
    assert list(built) == list(built.chain.layers) == list(built.layers)


def test_flow_routes_and_log_prob(data, monkeypatch):
    """log_prob equals the JAX flow's and runs per-layer under every policy;
    sampling runs the inner chain's sweep on chain_apply under True (its
    plain version here) and draws the same sample as under False."""
    jd, td = data
    jflow = df.Flow(randomize(jax_embedded(np.asarray(jd.x)), 5), jd)
    tflow = dt.Flow(to_torch(jflow.model), td, device="cpu")
    x = np.asarray(jd.x[:40])
    th = np.asarray(jd.theta[:40])
    want = np.asarray(jflow.log_prob(x, th))
    calls = []
    real = fc.run_chain

    def counting(plan, params, x2, th2, **k):
        calls.append((th2.shape[-1], k.get("with_ldj")))
        return real(plan, params, x2, th2, **k)

    monkeypatch.setattr(fc, "run_chain", counting)
    out = {}
    for mode in (True, False):
        dt.set_fused_kernels(mode)
        try:
            calls.clear()
            with torch.no_grad():
                lp = tflow.log_prob(x, th)
                lp_calls = list(calls)
                s = tflow.sample((30,), tuple(th[0]),
                                 generator=torch.Generator().manual_seed(1))
            out[mode] = (lp, s, lp_calls, list(calls))
        finally:
            dt.set_fused_kernels("auto")
        np.testing.assert_allclose(lp.numpy(), want, **TOL)
    assert out[True][2] == [] and out[True][3] == [(E, False)]
    assert out[False][3] == []
    np.testing.assert_allclose(out[True][1].numpy(), out[False][1].numpy(),
                               **TOL)


def test_two_epochs_of_train_equal_jax(data):
    jd, td = data
    jflow = df.Flow(jax_embedded(np.asarray(jd.x)), jd)
    tflow = dt.Flow(to_torch(jflow.model), td, device="cpu")
    embed0 = [w.detach().clone() for w in tflow.model.embed.weights]
    key = jax.random.key(6)
    js = df.train(jflow, jd, epochs=2, batchsize=16, verbose=False, key=key,
                  fused_kernel=False)
    perms = jax_epoch_perms(key, 2, len(td.partition.training))
    ts = dt.train(tflow, td, epochs=2, batchsize=16, verbose=False,
                  _epoch_perms=perms)
    np.testing.assert_allclose(tflow.train_loss, jflow.train_loss,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(tflow.valid_loss, jflow.valid_loss,
                               atol=TRAIN_ATOL)
    assert_leaves_close(jflow.model, tflow.model, TRAIN_ATOL, "embedded")
    # the embedding got gradients and moved
    assert all(not torch.equal(a, w.detach()) for a, w in
               zip(embed0, tflow.model.embed.weights))
    assert_opt_state_close(js, tflow.model, ts, TRAIN_ATOL)


def test_whole_run_kernel_declines_by_name(data, monkeypatch):
    jd, td = data
    flow = dt.Flow(to_torch(jax_embedded(np.asarray(jd.x))), td,
                   device="cpu")
    with pytest.raises(dt.UnsupportedFusedTrain, match="EmbeddedChain"):
        dt.train(flow, td, epochs=1, verbose=False, fused_kernel=True)
    # "auto" on a CUDA flow (faked: no card here) records the decline
    fake_cuda(flow, monkeypatch)
    with pytest.warns(RuntimeWarning, match="EmbeddedChain"):
        dt.train(flow, td, epochs=1, batchsize=32, verbose=False,
                 generator=torch.Generator().manual_seed(0))
    assert "needs a FlowChain, got EmbeddedChain" in flow.fused_decline_reason
    assert flow.trained_path == "torch" and len(flow.train_loss) == 1


def test_checkpoints_and_adam_state_across_packages(data, tmp_path):
    jd, td = data
    tx = optax.adam(1e-3)
    jflow = df.Flow(jax_embedded(np.asarray(jd.x)), jd)
    js = df.train(jflow, jd, tx, epochs=1, batchsize=32, verbose=False,
                  key=jax.random.key(1), fused_kernel=False)
    df.save_flow(str(tmp_path / "j"), jflow, js)
    tflow, ts = dt.load_flow(str(tmp_path / "j"), dt.adam(), device="cpu")
    assert isinstance(tflow.model, dt.EmbeddedChain)
    assert_opt_state_close(js, tflow.model, ts, 0.0)
    # embed first, then the chain
    leaves = trainable_leaves(tflow.model)
    assert leaves[0] is tflow.model.embed.weights[0]
    x, th = np.asarray(jd.x[:20]), np.asarray(jd.theta[:20])
    with torch.no_grad():
        np.testing.assert_allclose(tflow.log_prob(x, th).numpy(),
                                   np.asarray(jflow.log_prob(x, th)), **TOL)
    ts2 = dt.train(tflow, td, dt.adam(), ts, epochs=1, batchsize=32,
                   verbose=False, generator=torch.Generator().manual_seed(2))
    dt.save_flow(str(tmp_path / "t"), tflow, ts2)
    jback, jstate = df.load_flow(str(tmp_path / "t"), tx)
    assert_opt_state_close(jstate, tflow.model, ts2, 0.0)
    assert_leaves_close(jback.model, tflow.model, 0.0)
    np.testing.assert_allclose(
        np.asarray(jback.log_prob(jnp.asarray(x), jnp.asarray(th))),
        tflow.log_prob(x, th).detach().numpy(), **TOL)
