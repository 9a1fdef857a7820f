"""PyTorch port vs the JAX package on the CPU: every ported layer, block and
chain — forward / inverse / forward_, ldj, max_log_scale, no-bias nets,
n = 0. Same numpy weights and inputs through both; tolerance 2e-5 abs+rel
(f32 on both sides, sums in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import layers as JL

from _torch_parity import TOL, inputs, mixed_chain, randomize, t, to_torch


@pytest.fixture(autouse=True)
def per_layer_paths():
    # hold the per-layer paths of both packages against each other
    JL.set_fused_kernels(False)
    dt.set_fused_kernels(False)
    yield
    JL.set_fused_kernels("auto")
    dt.set_fused_kernels("auto")


def _compare(jl, x, theta, tol=TOL):
    """forward, inverse and forward_ of a JAX element and its port."""
    tl = to_torch(jl)
    jx, jth = jnp.asarray(x), jnp.asarray(theta)
    tx, tth = t(x), t(theta)
    for name in ("forward", "inverse"):
        jy, jldj = getattr(jl, name)(jx, jth)
        ty, tldj = getattr(tl, name)(tx, tth)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **tol)
        np.testing.assert_allclose(tldj.detach().numpy(), np.asarray(jldj),
                                   **tol)
        assert tuple(tldj.shape) == x.shape[:-1]
    np.testing.assert_allclose(tl.forward_(tx, tth).detach().numpy(),
                               np.asarray(jl.forward_(jx, jth)), **tol)
    # round trip in the port itself
    y, l1 = tl.forward(tx, tth)
    back, l2 = tl.inverse(y, tth)
    np.testing.assert_allclose(back.detach().numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((l1 + l2).detach().numpy(), 0.0, atol=1e-4)
    return tl


COUPLINGS = {
    "rnvp": dict(),
    "rnvp_clamped": dict(max_log_scale=1.5),
    "rnvp_nobias": dict(bias=False),
    "rnvp_tanh_3_sublayers": dict(activation_s="tanh", activation_t="gelu",
                                  n_sublayers_s=3, n_sublayers_t=1),
    "nice": dict(kind=df.NICECouplingLayer),
    "joint": dict(joint_conditioner=True),
    "joint_clamped_nobias": dict(joint_conditioner=True, max_log_scale=2.0,
                                 bias=False),
}


@pytest.mark.parametrize("name", sorted(COUPLINGS))
@pytest.mark.parametrize("n", [0, 2])
def test_coupling_layers_match_jax(name, n):
    d = 5
    kw = dict(hidden_dim_s=8, hidden_dim_t=8, key=jax.random.key(1))
    kw.update(COUPLINGS[name])
    layer = randomize(df.coupling_layer(d, [0, 3], n=n, **kw), 11)
    x, theta = inputs(d, n, 23, 5)
    _compare(layer, x, theta)


def test_coupling_layer_batch_dims():
    layer = randomize(df.coupling_layer(4, None, n=1, hidden_dim_s=8,
                                        hidden_dim_t=8), 2)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, 4)) * 0.5).astype(np.float32)
    theta = rng.uniform(size=(3, 7, 1)).astype(np.float32)
    _compare(layer, x, theta)


def test_normalization_layer_matches_jax():
    rng = np.random.default_rng(3)
    x_ref = rng.normal(size=(50, 4)).astype(np.float32) * 3.0
    layer = df.normalization_layer(x_ref, -1.0, 1.0)
    x, theta = inputs(4, 0, 17, 2)
    tl = _compare(layer, x, theta)
    built = dt.normalization_layer(x_ref, -1.0, 1.0, device="cpu")
    assert torch.equal(built.x_min, tl.x_min)
    assert torch.equal(built.x_max, tl.x_max)
    assert not list(built.parameters())  # bounds are buffers, not trainable
    with pytest.raises(ValueError):
        dt.normalization_layer(x_ref, 1.0, 1.0, device="cpu")
    with pytest.raises(ValueError):
        dt.normalization_layer(np.ones((5, 2), np.float32), device="cpu")


def test_permutation_layer_matches_jax():
    layer = df.permutation_layer([2, 0, 3, 1])
    x, theta = inputs(4, 0, 9, 3)
    _compare(layer, x, theta)
    assert dt.permutation_layer(4).perm == (3, 2, 1, 0)
    g = torch.Generator().manual_seed(0)
    assert sorted(dt.permutation_layer(6, generator=g).perm) == list(range(6))
    with pytest.raises(ValueError):
        dt.permutation_layer([0, 0, 1])


def test_logit_layer_matches_jax_and_clamps_edges():
    lo = np.array([-1.0, 0.0, 2.0], np.float32)
    hi = np.array([1.0, 3.0, 2.5], np.float32)
    layer = df.logit_layer((lo, hi))
    x, theta = inputs(3, 0, 13, 4)
    tl = to_torch(layer)
    jy, jl = layer.forward(jnp.asarray(x), None)
    ty, tldj = tl.forward(t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jl), **TOL)
    # inverse on points inside the box, on its edges and outside: finite
    pts = np.concatenate([np.asarray(jy), lo[None], hi[None],
                          (hi + 1.0)[None]]).astype(np.float32)
    jz, jl = layer.inverse(jnp.asarray(pts), None)
    tz, tl_ = tl.inverse(t(pts))
    assert np.isfinite(tz.numpy()).all()
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    built = dt.logit_layer(np.asarray(jy), margin=0.1, device="cpu")
    assert bool((built.hi > built.lo).all())
    with pytest.raises(ValueError):
        dt.logit_layer((hi, lo), device="cpu")


def test_actnorm_layer_matches_jax():
    rng = np.random.default_rng(6)
    x_ref = rng.normal(size=(80, 4)).astype(np.float32) * 2.0 + 1.0
    layer = df.actnorm_layer(x_ref)
    x, theta = inputs(4, 0, 15, 7)
    tl = _compare(layer, x, theta)
    built = dt.actnorm_layer(x_ref, device="cpu")
    np.testing.assert_allclose(built.bias.detach().numpy(),
                               tl.bias.detach().numpy(), **TOL)
    np.testing.assert_allclose(built.log_scale.detach().numpy(),
                               tl.log_scale.detach().numpy(), **TOL)
    ident = dt.actnorm_layer(3, device="cpu")
    z, ldj = ident.inverse(t(x[:, :3]))
    np.testing.assert_array_equal(z.detach().numpy(), x[:, :3])
    assert len(list(ident.parameters())) == 2  # trainable


def test_invertible_linear_layer_matches_jax():
    layer = df.invertible_linear_layer(5, key=jax.random.key(4))
    x, theta = inputs(5, 0, 12, 8)
    tl = _compare(layer, x, theta)
    np.testing.assert_allclose(tl._w().detach().numpy(),
                               np.asarray(layer._w()), **TOL)
    built = dt.invertible_linear_layer(
        5, generator=torch.Generator().manual_seed(1), device="cpu")
    w = built._w().detach().numpy()
    np.testing.assert_allclose(w @ w.T, np.eye(5), atol=1e-5)  # a rotation
    z, ldj = built.inverse(t(x))
    np.testing.assert_allclose(ldj.detach().numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("joint", [False, True])
def test_coupling_block_matches_jax(joint):
    block = randomize(df.coupling_block(6, None, n=2, hidden_dim_s=8,
                                        hidden_dim_t=8,
                                        joint_conditioner=joint), 9)
    x, theta = inputs(6, 2, 21, 1)
    tb = _compare(block, x, theta)
    assert len(tb) == 2
    with pytest.raises(ValueError):
        dt.CouplingBlock(tb.layer_1, tb.layer_1)


def test_mixed_chain_matches_jax():
    chain = mixed_chain()
    x, theta = inputs(6, 2, 29, 3)
    tc = _compare(chain, x, theta, tol=dict(rtol=1e-4, atol=1e-4))
    assert len(tc) == len(chain)
    assert tc.summarize() == chain.summarize()
    assert len(tc[1:3]) == 2
    assert len(dt.concatenate(tc, tc[0], [tc[1]])) == len(tc) + 2


def test_factories_build_the_jax_shapes_and_defaults():
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    data = dt.DataArrays.make(rng.normal(size=(30, 5)).astype(np.float32),
                              rng.normal(size=(30, 2)).astype(np.float32),
                              rng=0)
    layer = dt.coupling_layer(data, [0, 1], generator=g, device="cpu")
    jl = df.coupling_layer(5, [0, 1], n=2)
    assert layer.s_net.dims == jl.s_net.dims == (5, 32, 32, 2)
    assert layer.t_net.activation == "relu" and layer.max_log_scale == 0.0
    # identity at init (zero_init_final default)
    x, theta = inputs(5, 2, 7, 0)
    y, ldj = layer.forward(t(x), t(theta))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    assert float(ldj.detach().abs().max()) == 0.0
    joint = dt.coupling_layer(5, 2, n=1, joint_conditioner=True,
                              generator=g, device="cpu")
    assert joint.st_net.dims == (3, 32, 32, 6)
    with pytest.raises(ValueError):
        dt.coupling_layer(5, 2, joint_conditioner=True, hidden_dim_s=8,
                          device="cpu")
    with pytest.raises(ValueError):
        dt.coupling_layer(5, 2, joint_conditioner=True,
                          kind=dt.NICECouplingLayer, device="cpu")
    with pytest.raises(NotImplementedError):
        dt.coupling_layer(5, 2, kind=object, device="cpu")
    block = dt.coupling_block(data, None, generator=g, device="cpu",
                              hidden_dim_s=4, hidden_dim_t=4)
    assert dt.is_reverse(block.layer_1.axes, block.layer_2.axes)
    chain = dt.flow_chain(dt.coupling_layer, 3, 5, 2)(generator=g,
                                                     device="cpu")
    assert len(chain) == 3
    w = [l.s_net.weights[0] for l in chain]
    assert not torch.equal(w[0], w[1])  # independently initialised


def test_set_fused_kernels_validates():
    with pytest.raises(ValueError):
        dt.set_fused_kernels("sometimes")
