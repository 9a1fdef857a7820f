"""The port's MADE conditioner (``ops/made.py``) and MAF / IAF layers
(``models/autoregressive.py``) against the JAX package on the CPU: the masks
equal JAX's exactly, the autoregressive property (a triangular Jacobian),
both directions of both layers, NLL gradients against ``jax.grad``, the
masks kept out of the checkpoint leaves and applied as ``w * mask`` on every
call, checkpoints across the two packages (a legacy mask spec included).

Tolerance: ``TOL`` (2e-5), f32 on both sides summed in another order;
gradients 1e-4 relative (sums over the batch in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.ops.made import made_masks as jax_made_masks
from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops.made import apply_made, init_made, made_masks
from densityflows_tpu_torch.utils.checkpoint import (
    element_from_spec, element_leaves, element_spec)

from _torch_parity import TOL, inputs, t, to_torch

D, N = 5, 2


@pytest.mark.parametrize("desc", [(5, 2, 2, (16, 16)), (1, 0, 2, (4,)),
                                  (7, 3, 3, (5, 9, 6)), (2, 1, 1, (1,))])
def test_made_masks_equal_jax_exactly(desc):
    got, want = made_masks(*desc), jax_made_masks(*desc)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and not a.flags.writeable
        np.testing.assert_array_equal(a, b)


def _randomize_ar(layer, seed):
    """Every MADE weight and bias drawn from numpy, the masked-out entries
    included (the stored weights are unmasked, in both packages)."""
    rng = np.random.default_rng(seed)
    net = layer.net
    ws = tuple(jnp.asarray(rng.normal(size=w.shape).astype(np.float32)
                           * (0.8 / np.sqrt(w.shape[0]))) for w in net.weights)
    bs = tuple(jnp.asarray(rng.normal(size=b.shape).astype(np.float32) * 0.1)
               for b in net.biases)
    return dataclasses.replace(layer, net=dataclasses.replace(
        net, weights=ws, biases=bs))


def _layers():
    return {
        "maf": _randomize_ar(df.maf_layer(D, n=N, key=jax.random.key(1),
                                          hidden_dim=16), 2),
        "iaf": _randomize_ar(df.iaf_layer(D, n=N, key=jax.random.key(3),
                                          hidden_dim=16, max_log_scale=1.5,
                                          activation="tanh"), 4),
    }


def test_autoregressive_jacobian_is_triangular():
    """d out[i·P + p] / d x_j is zero for j ≥ i, whatever the weights, and
    the weights off the mask have zero gradient."""
    net = to_torch(_layers()["maf"].net)
    h0 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N + D,)).astype(np.float32))
    jac = torch.autograd.functional.jacobian(lambda h: apply_made(net, h), h0)
    jx = jac[:, N:].reshape(D, 2, D)
    for i in range(D):
        assert float(jx[i, :, i:].abs().max()) == 0.0
    assert float(jx[1:, :, 0].abs().min()) > 0.0   # and it is not all zero
    out = apply_made(net, h0[None].repeat(3, 1)).sum()
    grads = torch.autograd.grad(out, list(net.weights))
    for g, m in zip(grads, net.masks("cpu")):
        assert float((g * (1 - m)).abs().max()) == 0.0
    # the stored weights stay unmasked
    assert any(float((w.detach() * (1 - m)).abs().max()) > 0
               for w, m in zip(net.weights, net.masks("cpu")))


@pytest.mark.parametrize("kind", ["maf", "iaf"])
def test_layer_directions_equal_jax(kind):
    jl = _layers()[kind]
    tl = to_torch(jl)
    assert isinstance(tl, dt.MAFLayer if kind == "maf" else dt.IAFLayer)
    assert tl.summarize() == jl.summarize()
    x, th = inputs(D, N, 60, 5)
    fwd, inv = jax.jit(jl.forward), jax.jit(jl.inverse)
    for got, want in ((tl.forward(t(x), t(th)), fwd(x, th)),
                      (tl.inverse(t(x), t(th)), inv(x, th))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)
    np.testing.assert_allclose(tl.forward_(t(x), t(th)).detach().numpy(),
                               np.asarray(fwd(x, th)[0]), **TOL)
    # and the two directions invert each other
    z, ldj = tl.inverse(t(x), t(th))
    back, ldj_f = tl.forward(z, t(th))
    np.testing.assert_allclose(back.detach().numpy(), x, atol=1e-5)
    np.testing.assert_allclose((ldj + ldj_f).detach().numpy(), 0.0,
                               atol=1e-5)


def test_builders():
    g = torch.Generator().manual_seed(0)
    maf = dt.maf_layer(4, n=3, generator=g, hidden_dim=8, n_sublayers=3,
                       device="cpu")
    jmaf = df.maf_layer(4, n=3, hidden_dim=8, n_sublayers=3)
    assert element_spec(maf) == jax_spec(jmaf)
    assert maf.net.dims == (7, 8, 8, 8, 8)
    # zero final layer: the identity at init
    x, th = inputs(4, 3, 6, 1)
    y, ldj = maf.forward(t(x), t(th))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    assert float(ldj.detach().abs().max()) == 0.0
    iaf = dt.iaf_layer(4, generator=g, device="cpu", activation="silu")
    assert element_spec(iaf) == jax_spec(df.iaf_layer(4, activation="silu"))
    net = init_made(g, 3, 1, 2, hidden_dim=5, zero_final=False, device="cpu")
    assert float(net.weights[-1].detach().abs().max()) > 0
    with pytest.raises(ValueError, match="activation"):
        dt.maf_layer(3, activation="nope", device="cpu")


def _maf_flow():
    ks = jax.random.split(jax.random.key(7), 2)
    chain = df.flow_chain(
        _randomize_ar(df.maf_layer(D, n=N, key=ks[0], hidden_dim=12), 8),
        df.permutation_layer(D),
        _randomize_ar(df.iaf_layer(D, n=N, key=ks[1], hidden_dim=12), 9))
    meta = df.MetaData("maf", D, N, np.zeros(N, np.float32),
                       np.ones(N, np.float32))
    return df.Flow(chain, meta)


def test_nll_gradients_equal_jax_grad():
    chain = _maf_flow().model
    x, th = inputs(D, N, 32, 6)
    jl, jg = jax.jit(jax.value_and_grad(lambda c: df.nll_loss(
        c, df.StandardNormal(D), jnp.asarray(x), jnp.asarray(th))))(chain)
    tchain = to_torch(chain)
    leaves = trainable_leaves(tchain)
    # the masks are no leaves: weights and biases only, as in JAX
    assert len(element_leaves(tchain)) == len(jax.tree_util.tree_leaves(chain))
    loss = dt.nll_loss(tchain, dt.StandardNormal(D), t(x), t(th))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for g, jgrad in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["maf", "iaf"])
def test_checkpoints_across_packages(kind, tmp_path):
    """A JAX save_flow of a flow holding the layer (and, for "maf", the MAF /
    permutation / IAF chain) loads in the port with equal log_prob, and the
    port's save_flow loads in the JAX package."""
    jflow = (_maf_flow() if kind == "maf" else df.Flow(
        df.flow_chain(_layers()["iaf"]), _maf_flow().metadata))
    x, th = inputs(D, N, 30, 9)
    want = np.asarray(jflow.log_prob(x, th))
    df.save_flow(str(tmp_path / "j"), jflow)
    tflow = dt.load_flow(str(tmp_path / "j"), device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(tflow.log_prob(x, th).numpy(), want, **TOL)
        s = tflow.sample((7,), (0.3, 0.6),
                         generator=torch.Generator().manual_seed(0))
    assert s.shape == (7, D) and bool(torch.isfinite(s).all())
    dt.save_flow(str(tmp_path / "t"), tflow)
    back = df.load_flow(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(back.log_prob(x, th)), want)


def test_legacy_mask_spec():
    """A spec of the older format stores the mask grids instead of the
    descriptor; the port infers the descriptor and checks the masks."""
    jnet = _layers()["maf"].net
    spec = jax_spec(jnet)
    legacy = {k: v for k, v in spec.items() if k != "made"}
    legacy["masks"] = [m.tolist() for m in jax_made_masks(
        *jnet.made[:3], tuple(jnet.made[3]))]
    net = element_from_spec(legacy, "cpu")
    assert net.made == (D, N, 2, (16, 16))
    assert element_spec(net) == spec
    bad = dict(legacy, masks=[np.ones_like(np.asarray(m)).tolist()
                              for m in legacy["masks"]])
    with pytest.raises(ValueError, match="MADE descriptor"):
        element_from_spec(bad, "cpu")
