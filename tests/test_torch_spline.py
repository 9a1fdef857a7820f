"""The port's spline transform (``ops/spline.py``) and spline coupling layer
(``RQSCouplingLayer``) against the JAX package on the CPU: ``rq_spline`` at
knots, outside ±bound and on NaN / inf inputs and parameters against the
JAX one-hot form as its entry points run it, compiled by ``jax.jit`` (its
NaN pattern in the output and the ldj included; op by op, without XLA's
rewrite of the contraction into a select, a NaN in another bin of an
element's parameters would spread into it as well), the
layer's directions and its NLL gradients, 2 epochs of ``train()`` with the
JAX batch order, a mixed RQS + RealNVP chain under every kernel policy, the
declines of the kernel routes by name, and checkpoints in both directions.

Tolerance: ``TOL`` (2e-5) for one transform or layer; ``TRAIN_ATOL``
(1e-4) for the 2-epoch loss histories (float accumulation order through
Adam, the JAX suite's own bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.ops.spline import rq_spline as jax_rq_spline
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.models.fused_train import (
    chain_train_fold, trainable_leaves)
from densityflows_tpu_torch.ops.spline import n_spline_params, rq_spline

from _torch_parity import (
    TOL, TRAIN_ATOL, assert_leaves_close, cond_data, fake_cuda, inputs,
    jax_epoch_perms, randomize, t, to_torch, torch_flow)

K, B = 5, 2.0


def _spline_case(seed=0, rows=64, a=3):
    rng = np.random.default_rng(seed)
    params = rng.normal(size=(rows, a, 3 * K - 1)).astype(np.float32)
    x = (rng.uniform(-1.4, 1.4, size=(rows, a)) * B).astype(np.float32)
    # both edges, values outside ±bound, a NaN and infs
    x[0, :] = [-B, B, 0.0]
    x[1, :] = [np.nan, np.inf, -np.inf]
    x[2, :] = [B + 1e-6, -B - 1e-6, 5.0 * B]
    # parameters with a NaN in a width, a height and one derivative, and an
    # inf derivative and a -inf width (a zero-width bin, still finite)
    params[3, 0, 1] = np.nan
    params[4, 1, K + 2] = np.nan
    params[5, 2, 2 * K + 1] = np.nan
    params[6, 0, 2 * K] = np.inf
    params[7, 1, 0] = -np.inf
    params[8, :, :] = 40.0          # saturated softmax and softplus
    return x, params


def _knot_inputs(params, inverse):
    """Inputs exactly at an interior knot of each element, as the JAX
    package computes the knots."""
    from densityflows_tpu.ops.spline import _make_knots

    n = (params.shape[-1] + 1) // 3
    p = jnp.asarray(params)
    xk, yk, *_ = _make_knots(p[..., :n], p[..., n:2 * n], p[..., 2 * n:],
                             B, n)
    knots = np.asarray(yk if inverse else xk)
    rows, a = params.shape[:2]
    idx = 1 + (np.arange(a) + np.arange(rows)[:, None]) % (n - 1)
    return np.take_along_axis(knots, idx[..., None], -1)[..., 0]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("with_ldj", [True, False])
def test_rq_spline_equals_the_jax_one_hot_form(inverse, with_ldj):
    x, params = _spline_case()
    x[9:12] = _knot_inputs(params[9:12], inverse)
    jy, jl = jax.jit(lambda a, p: jax_rq_spline(
        a, p, bound=B, inverse=inverse, with_ldj=with_ldj))(
            jnp.asarray(x), jnp.asarray(params))
    ty, tl = rq_spline(t(x), t(params), bound=B, inverse=inverse,
                       with_ldj=with_ldj)
    jy, ty = np.asarray(jy), ty.numpy()
    # the NaN pattern is the JAX package's, element for element
    np.testing.assert_array_equal(np.isnan(ty), np.isnan(jy))
    assert np.isnan(jy[3:6]).any() and np.isnan(jy[1, 0])
    np.testing.assert_allclose(ty, jy, **TOL)   # NaN == NaN, inf == inf
    # outside ±bound (and on ±inf) the identity, exactly
    np.testing.assert_array_equal(ty[2], x[2])
    np.testing.assert_array_equal(ty[1, 1:], x[1, 1:])
    if not with_ldj:
        assert jl is None and tl is None
        return
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    off = np.ones(len(x), bool)
    off[9:12] = False
    np.testing.assert_allclose(tl[off], jl[off], **TOL)
    # at an exact knot the two packages' cumulative sums of the bin widths
    # may differ by an ulp, which puts the input in the neighbouring bin: the
    # derivative is continuous there, but a steep narrow bin moves it by up
    # to about 1e-4 relative over that ulp
    np.testing.assert_allclose(tl[~off], jl[~off], rtol=1e-3, atol=2e-5)
    assert (tl[2] == 0).all() and (tl[1] == 0).all()


def test_spline_round_trip_and_broadcast():
    x, params = _spline_case(1)
    ok = slice(9, None)
    y, ldj = rq_spline(t(x[ok]), t(params[ok]), bound=B)
    back, ldj_b = rq_spline(y, t(params[ok]), bound=B, inverse=True)
    np.testing.assert_allclose(back.numpy(), x[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((ldj + ldj_b).numpy(), 0.0, atol=1e-4)
    # one parameter row broadcast against a batch of inputs
    p1 = params[20, 0]
    got, _ = rq_spline(t(x[ok, 0]), t(p1)[None].expand(x[ok].shape[0], -1),
                       bound=B)
    want, _ = jax_rq_spline(jnp.asarray(x[ok, 0]), jnp.asarray(p1), bound=B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert n_spline_params(8) == 23


def _rqs_layer(d=6, n=2, seed=1, **kw):
    layer = df.coupling_layer(d, [0, 2, 4], n=n, kind=df.RQSCouplingLayer,
                              key=jax.random.key(seed), hidden_dim_t=16,
                              n_bins=K, bound=B, **kw)
    return randomize(layer, seed + 10)


def test_rqs_layer_directions_equal_jax():
    jl = _rqs_layer()
    tl = to_torch(jl)
    assert tl.p_net.dims == jl.p_net.dims == (5, 16, 16, 3 * (3 * K - 1))
    x, th = inputs(6, 2, 80, 3)
    x = x * 4.0                     # some dims beyond ±bound
    for dirn in ("forward", "inverse"):
        want = jax.jit(getattr(jl, dirn))(jnp.asarray(x), jnp.asarray(th))
        got = getattr(tl, dirn)(t(x), t(th))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)
    np.testing.assert_allclose(
        tl.forward_(t(x), t(th)).detach().numpy(),
        np.asarray(jl.forward_(jnp.asarray(x), jnp.asarray(th))), **TOL)
    assert tl.summarize() == jl.summarize()


def test_rqs_builders_match_jax():
    g = torch.Generator().manual_seed(0)
    layer = dt.coupling_layer(7, 3, n=2, kind=dt.RQSCouplingLayer, n_bins=4,
                              bound=2.5, generator=g, device="cpu",
                              hidden_dim_t=8, n_sublayers_t=3)
    assert (layer.n_bins, layer.bound) == (4, 2.5)
    assert layer.p_net.dims == (5, 8, 8, 8, 4 * 11)
    # zero_init_final: raw parameters 0 whatever the hidden weights, so the
    # layer equals the JAX layer of the same axes at init
    jlayer = df.coupling_layer(7, 3, n=2, kind=df.RQSCouplingLayer, n_bins=4,
                               bound=2.5, hidden_dim_t=8, n_sublayers_t=3)
    x, th = inputs(7, 2, 9, 0)
    for a, b in zip(layer.forward(t(x), t(th)),
                    jax.jit(jlayer.forward)(jnp.asarray(x), jnp.asarray(th))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    block = dt.coupling_block(7, None, n=2, kind=dt.RQSCouplingLayer,
                              generator=g, device="cpu", n_bins=3)
    jblock = df.coupling_block(7, None, n=2, kind=df.RQSCouplingLayer,
                               n_bins=3)
    from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
    from densityflows_tpu_torch.utils.checkpoint import element_spec
    assert element_spec(block) == jax_spec(jblock)
    with pytest.raises(NotImplementedError, match="RQSCouplingLayer"):
        dt.coupling_layer(5, 2, kind=dt.MAFLayer, device="cpu")


def mixed_rqs_chain(jd, x, seed=0):
    ks = jax.random.split(jax.random.key(seed), 3)
    return df.flow_chain(
        df.coupling_block(jd, None, kind=df.RQSCouplingLayer, key=ks[0],
                          hidden_dim_t=12, n_bins=4, bound=3.0),
        df.coupling_layer(jd, [0, 1, 2], key=ks[1], hidden_dim_s=12,
                          hidden_dim_t=12),
        df.coupling_layer(jd, [2, 3, 4], key=ks[2], hidden_dim_s=12,
                          hidden_dim_t=12),
        df.normalization_layer(x, -1.0, 1.0))


@pytest.fixture(scope="module")
def cond():
    return cond_data()


def test_nll_gradients_equal_jax_grad(cond):
    jd, _, x = cond
    ks = jax.random.split(jax.random.key(2), 2)
    chain = randomize(df.flow_chain(
        df.coupling_layer(jd, [0, 1, 2], kind=df.RQSCouplingLayer, key=ks[0],
                          hidden_dim_t=8, n_bins=4),
        df.coupling_layer(jd, [2, 3, 4], key=ks[1], hidden_dim_s=8,
                          hidden_dim_t=8)), 4)
    xx, th = inputs(5, 1, 64, 5)
    xx = xx * 3.0
    jl, jg = jax.jit(jax.value_and_grad(lambda c: df.nll_loss(
        c, df.StandardNormal(5), jnp.asarray(xx), jnp.asarray(th))))(chain)
    tchain = to_torch(chain)
    loss = dt.nll_loss(tchain, dt.StandardNormal(5), t(xx), t(th))
    leaves = trainable_leaves(tchain)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    from densityflows_tpu_torch.utils.checkpoint import element_leaves
    pos = {id(p): i for i, p in enumerate(leaves)}
    for leaf, jgrad in zip(element_leaves(tchain), jleaves):
        if id(leaf) in pos:
            np.testing.assert_allclose(grads[pos[id(leaf)]].numpy(), jgrad,
                                       rtol=1e-4, atol=1e-5)


def test_two_epochs_of_train_equal_jax(cond):
    jd, td, x = cond
    jflow = df.Flow(mixed_rqs_chain(jd, x), jd)
    tflow = torch_flow(jflow, td)
    key = jax.random.key(3)
    df.train(jflow, jd, epochs=2, batchsize=32, verbose=False, key=key)
    perms = jax_epoch_perms(key, 2, len(td.partition.training))
    dt.train(tflow, td, epochs=2, batchsize=32, verbose=False,
             _epoch_perms=perms)
    assert tflow.trained_path == "torch"
    np.testing.assert_allclose(tflow.train_loss, jflow.train_loss,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(tflow.valid_loss, jflow.valid_loss,
                               atol=TRAIN_ATOL)
    assert_leaves_close(jflow.model, tflow.model, TRAIN_ATOL, "rqs")


def test_mixed_chain_under_every_policy(cond, monkeypatch):
    """Under True the RealNVP layers of the mixed chain take the per-layer
    coupling op (its plain version here) and the RQS layers plain autograd;
    loss and gradients equal those under False. The chain route declines
    the chain, and the whole-run kernel declines it by name."""
    from densityflows_tpu_torch.ops import coupling_kernels as cpk

    jd, td, x = cond
    chain = to_torch(randomize(mixed_rqs_chain(jd, x), 6))
    assert not fc.chain_is_fusable(chain, 5, 1)
    xx, th = inputs(5, 1, 40, 7)
    calls = []
    real = cpk.fused_coupling

    def counting(*a, **k):
        calls.append(k["direction"])
        return real(*a, **k)

    monkeypatch.setattr(cpk, "fused_coupling", counting)
    out = {}
    for mode in (True, False):
        dt.set_fused_kernels(mode)
        try:
            calls.clear()
            loss = dt.nll_loss(chain, dt.StandardNormal(5), t(xx), t(th))
            grads = torch.autograd.grad(loss, trainable_leaves(chain))
            out[mode] = (loss.detach(), grads, list(calls))
        finally:
            dt.set_fused_kernels("auto")
    assert out[True][2] == ["inverse", "inverse"] and out[False][2] == []
    np.testing.assert_allclose(out[True][0], out[False][0], **TOL)
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    with pytest.raises(fc._Unsupported, match="RQSCouplingLayer"):
        fc.fold_layers(chain, t(xx), t(th), "inv", True)
    with pytest.raises(dt.UnsupportedFusedTrain, match="RQSCouplingLayer"):
        chain_train_fold(chain)
    flow = dt.Flow(chain, td, device="cpu")
    with pytest.raises(dt.UnsupportedFusedTrain, match="RQSCouplingLayer"):
        dt.train(flow, td, epochs=1, verbose=False, fused_kernel=True)


def test_auto_decline_names_the_spline_layer(cond, monkeypatch):
    """On a CUDA flow "auto" tries the whole-run kernel, which declines the
    spline chain by name; the reason lands in flow.fused_decline_reason and
    the plain program trains it (the device is faked: no card here)."""
    jd, td, x = cond
    flow = torch_flow(df.Flow(mixed_rqs_chain(jd, x), jd), td)
    fake_cuda(flow, monkeypatch)
    with pytest.warns(RuntimeWarning, match="RQSCouplingLayer"):
        dt.train(flow, td, epochs=1, batchsize=32, verbose=False,
                 generator=torch.Generator().manual_seed(0))
    assert flow.trained_path == "torch"
    assert "RQSCouplingLayer is outside" in flow.fused_decline_reason


def test_checkpoints_across_packages(cond, tmp_path):
    jd, td, x = cond
    jflow = df.Flow(randomize(mixed_rqs_chain(jd, x), 8), jd)
    xx = x[:50] * 1.5
    th = np.asarray(jd.theta[:50])
    want = np.asarray(jflow.log_prob(jnp.asarray(xx), jnp.asarray(th)))
    df.save_flow(str(tmp_path / "j"), jflow)
    tflow = dt.load_flow(str(tmp_path / "j"), device="cpu")
    with torch.no_grad():
        got = tflow.log_prob(xx, th).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dt.save_flow(str(tmp_path / "t"), tflow)
    back = df.load_flow(str(tmp_path / "t"))
    np.testing.assert_array_equal(
        np.asarray(back.log_prob(jnp.asarray(xx), jnp.asarray(th))), want)
