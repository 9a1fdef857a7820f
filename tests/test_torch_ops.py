"""PyTorch port vs the JAX package on the CPU: ops (MLP, coupling
transforms), axes, and the data helpers. Same numpy inputs through both;
tolerance 2e-5 abs+rel (f32 on both sides, sums in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu import axes as jaxes
from densityflows_tpu import data as jdata
from densityflows_tpu.ops import coupling as JC
from densityflows_tpu.ops.mlp import ACTIVATIONS as JAX_ACTS
from densityflows_tpu_torch import axes as taxes
from densityflows_tpu_torch import data as tdata
from densityflows_tpu_torch.ops import coupling as TC
from densityflows_tpu_torch.ops.mlp import ACTIVATIONS as TORCH_ACTS
from densityflows_tpu_torch.ops.mlp import count_params

from _torch_parity import TOL, randomize, t, to_torch


@pytest.mark.parametrize("act", sorted(JAX_ACTS))
def test_mlp_matches_jax_for_every_activation(act):
    rng = np.random.default_rng(3)
    mlp = randomize(df.init_mlp(jax.random.key(0), 5, 3, 2, hidden_dim=8,
                                activation=act), 7)
    x = (rng.normal(size=(19, 5)) * 2.0).astype(np.float32)
    want = np.asarray(df.apply_mlp(mlp, jnp.asarray(x)))
    tm = to_torch(mlp)
    got = dt.apply_mlp(tm, t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert tm.dims == mlp.dims
    assert tm.activation == act


def test_activation_sets_agree():
    assert sorted(TORCH_ACTS) == sorted(JAX_ACTS)


def test_mlp_without_bias_and_batch_dims():
    rng = np.random.default_rng(4)
    mlp = randomize(df.init_mlp(jax.random.key(1), 4, 2, 3, hidden_dim=6,
                                bias=False), 8)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    tm = to_torch(mlp)
    assert not tm.has_bias
    np.testing.assert_allclose(
        dt.apply_mlp(tm, t(x)).detach().numpy(),
        np.asarray(df.apply_mlp(mlp, jnp.asarray(x))), **TOL)


def test_init_mlp_glorot_bounds_zero_final_and_count():
    g = torch.Generator().manual_seed(0)
    mlp = dt.init_mlp(g, 7, 3, 2, hidden_dim=16, zero_final=True,
                      device="cpu")
    assert [tuple(w.shape) for w in mlp.weights] == [(7, 16), (16, 16),
                                                     (16, 3)]
    for w in list(mlp.weights)[:-1]:
        limit = np.sqrt(6.0 / sum(w.shape))
        assert float(w.detach().abs().max()) <= limit
        assert float(w.detach().abs().max()) > 0.5 * limit  # glorot, not Linear's init
    assert float(mlp.weights[-1].detach().abs().max()) == 0.0
    assert all(float(b.detach().abs().max()) == 0.0 for b in mlp.biases)
    assert count_params(mlp) == 7 * 16 + 16 * 16 + 16 * 3 + 16 + 16 + 3
    with pytest.raises(ValueError):
        dt.init_mlp(g, 2, 2, 0, device="cpu")
    # same generator state, same weights
    a = dt.init_mlp(torch.Generator().manual_seed(5), 3, 2, device="cpu")
    b = dt.init_mlp(torch.Generator().manual_seed(5), 3, 2, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a.weights, b.weights))


@pytest.mark.parametrize("d,mask,n,reverse", [
    (5, None, 0, False), (6, 2, 3, False), (6, 2, 3, True),
    (7, [0, 3, 6], 2, False), (4, [3, 1], 1, False),
])
def test_axes_match_jax(d, mask, n, reverse):
    a = jaxes.coupling_axes(d, mask, n=n, reverse=reverse)
    b = taxes.coupling_axes(d, mask, n=n, reverse=reverse)
    for f in ("d", "n", "axis_id", "axis_af", "axis_nn"):
        assert getattr(a, f) == getattr(b, f)
    ar, br = a.reverse(), taxes.reverse_axes(b)
    assert (ar.axis_id, ar.axis_af, ar.axis_nn) == (br.axis_id, br.axis_af,
                                                    br.axis_nn)
    assert taxes.is_reverse(b, br)
    assert b.nn_input_dim == a.nn_input_dim
    assert b.summarize() == a.summarize()


def test_axes_errors_and_equality():
    with pytest.raises(ValueError):
        taxes.coupling_axes(4, [0, 0])
    with pytest.raises(ValueError):
        taxes.coupling_axes(4, [4])
    with pytest.raises(ValueError):
        taxes.coupling_axes(4, 5)
    with pytest.raises(ValueError):
        taxes.CouplingAxes(3, 0, (0,), (1,), (0,))
    a = taxes.coupling_axes(4, [1, 3])
    b = taxes.coupling_axes(4, [3, 1])
    assert a == b and hash(a) == hash(b)


def test_split_recombine_and_nn_input_match_jax():
    ax_j = jaxes.coupling_axes(6, [4, 1, 2], n=2)
    ax_t = taxes.coupling_axes(6, [4, 1, 2], n=2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 6)).astype(np.float32)
    th = rng.normal(size=(9, 2)).astype(np.float32)
    jid, jaf = JC.split_features(jnp.asarray(x), ax_j)
    tid, taf = TC.split_features(t(x), ax_t)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(taf.numpy(), np.asarray(jaf))
    np.testing.assert_array_equal(
        TC.recombine_features(tid, taf, ax_t).numpy(), x)
    np.testing.assert_array_equal(
        TC.nn_input(tid, t(th)).numpy(),
        np.asarray(JC.nn_input(jid, jnp.asarray(th))))


@pytest.mark.parametrize("name", ["rnvp_forward", "rnvp_backward",
                                  "nice_forward", "nice_backward"])
def test_coupling_transforms_match_jax(name):
    rng = np.random.default_rng(1)
    s, tt, y = (rng.normal(size=(11, 3)).astype(np.float32) for _ in range(3))
    args = (s, tt, y) if name.startswith("rnvp") else (tt, y)
    want = getattr(JC, name)(*[jnp.asarray(a) for a in args])
    got = getattr(TC, name)(*[t(a) for a in args])
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)
    assert got[1].shape == (11,)


def test_normalize_input_matches_jax_with_zero_range_guard():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    lo = np.array([-1.0, 0.5, 2.0], np.float32)
    hi = np.array([1.0, 0.5, 5.0], np.float32)  # dim 1 has zero range
    want = np.asarray(jdata.normalize_input(jnp.asarray(x), jnp.asarray(lo),
                                            jnp.asarray(hi)))
    got_t = tdata.normalize_input(t(x), t(lo), t(hi)).numpy()
    got_np = tdata.normalize_input(x, lo, hi)
    np.testing.assert_allclose(got_t, want, **TOL)
    np.testing.assert_allclose(got_np, want, **TOL)
    assert np.all(got_t[:, 1] == 0) and np.all(got_np[:, 1] == 0)
    back = tdata.resize_output(t(got_t[:, [0, 2]]), t(lo[[0, 2]]),
                               t(hi[[0, 2]])).numpy()
    np.testing.assert_allclose(back, x[:, [0, 2]], **TOL)


def test_data_arrays_split_and_metadata_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    th = rng.normal(size=(40, 2)).astype(np.float32)
    a = jdata.DataArrays.make(x, th, rng=7)
    b = tdata.DataArrays.make(x, th, rng=7)
    for part in ("training", "validation", "testing"):
        np.testing.assert_array_equal(getattr(a.partition, part),
                                      getattr(b.partition, part))
    ma, mb = a.metadata("h"), b.metadata("h")
    assert (ma.d, ma.n, ma.hash) == (mb.d, mb.n, mb.hash)
    np.testing.assert_array_equal(ma.theta_min, mb.theta_min)
    np.testing.assert_array_equal(ma.theta_max, mb.theta_max)
    assert tdata.dflt_theta(x).shape == (40, 0)
    u = tdata.DataArrays.make(x)
    assert u.num_conditions == 0 and u.minimum_theta.shape == (0,)
    with pytest.raises(ValueError):
        tdata.DataArrays.make(x[:, 0])
    with pytest.raises(ValueError):
        tdata.MetaData("", 3, 2, np.zeros(1), np.zeros(2))
