"""Leaf-order conversion from the JAX package to the PyTorch port, for every
ported element type: the port's module built from the JAX ``element_spec``
and the pytree leaves holds each array where the JAX dataclass holds it, and
writes the same spec and the same leaves back."""

import numpy as np
import jax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
from densityflows_tpu_torch.utils.checkpoint import (
    element_from_spec, element_leaves, element_spec, set_element_leaves)

from _torch_parity import mixed_chain, randomize, to_torch


def _leaves(el):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(el)]


def _x_ref(d):
    return np.random.default_rng(0).normal(size=(30, d)).astype(np.float32)


ELEMENTS = {
    "mlp": lambda: randomize(df.init_mlp(jax.random.key(0), 3, 2, 2,
                                         hidden_dim=4), 1),
    "mlp_nobias": lambda: randomize(df.init_mlp(jax.random.key(0), 3, 2, 1,
                                                hidden_dim=4, bias=False), 2),
    "rnvp": lambda: randomize(df.coupling_layer(
        4, [0, 2], n=1, hidden_dim_s=4, hidden_dim_t=6, max_log_scale=1.5), 3),
    "joint": lambda: randomize(df.coupling_layer(
        4, [1], n=2, hidden_dim_s=4, hidden_dim_t=4, joint_conditioner=True),
        4),
    "nice": lambda: randomize(df.coupling_layer(
        4, 2, kind=df.NICECouplingLayer, hidden_dim_t=4), 5),
    "normalization": lambda: df.normalization_layer(_x_ref(3), -1.0, 2.0),
    "permutation": lambda: df.permutation_layer([1, 2, 0]),
    "logit": lambda: df.logit_layer(_x_ref(3), margin=0.1, eps=1e-5),
    "actnorm": lambda: df.actnorm_layer(_x_ref(3)),
    "invlinear": lambda: df.invertible_linear_layer(4, key=jax.random.key(2)),
    "block": lambda: randomize(df.coupling_block(
        4, None, n=1, hidden_dim_s=4, hidden_dim_t=4), 6),
    "chain": mixed_chain,
    "standard_normal": lambda: df.StandardNormal(5),
    "diag_normal": lambda: df.DiagNormal(jax.numpy.arange(3.0),
                                         jax.numpy.ones(3) * 2),
    "gaussian_mixture": lambda: df.GaussianMixture(
        jax.numpy.arange(8.0).reshape(2, 4), jax.numpy.ones((2, 4)) * 0.5,
        jax.numpy.array([0.3, -0.2])),
    "box_uniform": lambda: df.BoxUniform(-jax.numpy.arange(1.0, 3.0),
                                         jax.numpy.arange(1.0, 3.0)),
    "rqs": lambda: randomize(df.coupling_layer(
        4, [1, 2], n=1, kind=df.RQSCouplingLayer, hidden_dim_t=4, n_bins=3,
        bound=2.0), 7),
    "maf": lambda: df.maf_layer(3, n=2, hidden_dim=5,
                                key=jax.random.key(1)),
    "iaf": lambda: df.iaf_layer(3, hidden_dim=4, max_log_scale=2.0,
                                key=jax.random.key(2)),
    "embedded": lambda: randomize(df.embed_conditions(
        df.flow_chain(df.coupling_block(4, None, n=2, hidden_dim_s=4,
                                        hidden_dim_t=4)), 5, 2,
        hidden_dim=3), 8),
}


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_spec_and_leaves_round_trip(name):
    jel = ELEMENTS[name]()
    tel = to_torch(jel)
    # same spec (so either package reads the other's spec.json) ...
    assert element_spec(tel) == jax_spec(jel)
    # ... and the same leaves in the same order
    got = [l.detach().numpy() for l in element_leaves(tel)]
    want = _leaves(jel)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_each_array_lands_in_its_field():
    jl = ELEMENTS["rnvp"]()
    tl = to_torch(jl)
    for net in ("s_net", "t_net"):
        jn, tn = getattr(jl, net), getattr(tl, net)
        for a, b in zip(tn.weights, jn.weights):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        for a, b in zip(tn.biases, jn.biases):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert tl.max_log_scale == 1.5 and tl.axes.axis_af == (0, 2)
    jn = ELEMENTS["normalization"]()
    tn = to_torch(jn)
    np.testing.assert_array_equal(tn.x_min.numpy(), np.asarray(jn.x_min))
    np.testing.assert_array_equal(tn.x_max.numpy(), np.asarray(jn.x_max))
    assert (tn.alpha, tn.beta) == (-1.0, 2.0)
    ja = ELEMENTS["actnorm"]()
    ta = to_torch(ja)
    np.testing.assert_array_equal(ta.bias.detach().numpy(),
                                  np.asarray(ja.bias))
    np.testing.assert_array_equal(ta.log_scale.detach().numpy(),
                                  np.asarray(ja.log_scale))
    ji = ELEMENTS["invlinear"]()
    ti = to_torch(ji)
    for f in ("lower", "upper", "log_s"):
        np.testing.assert_array_equal(getattr(ti, f).detach().numpy(),
                                      np.asarray(getattr(ji, f)))
    assert ti.perm == tuple(ji.perm) and ti.sign == tuple(ji.sign)
    jg = ELEMENTS["logit"]()
    tg = to_torch(jg)
    np.testing.assert_array_equal(tg.lo.numpy(), np.asarray(jg.lo))
    np.testing.assert_array_equal(tg.hi.numpy(), np.asarray(jg.hi))
    assert tg.eps == 1e-5


def test_flow_from_jax_numpy():
    chain = mixed_chain()
    base = df.StandardNormal(6)
    meta = df.MetaData("m", 6, 2, np.array([0.0, 1.0]), np.array([1.0, 3.0]))
    flow = dt.flow_from_jax_numpy(
        jax_spec(chain), _leaves(chain), jax_spec(base), _leaves(base), meta,
        "cpu", train_loss=[1.0])
    assert isinstance(flow, dt.Flow) and flow.metadata.hash == "m"
    assert flow.train_loss == [1.0] and flow.valid_loss == []
    np.testing.assert_array_equal(flow.metadata.theta_max, [1.0, 3.0])
    as_dict = dict(hash="m", d=6, n=2, theta_min=[0.0, 1.0],
                   theta_max=[1.0, 3.0])
    flow2 = dt.flow_from_jax_numpy(
        jax_spec(chain), _leaves(chain), jax_spec(base), [], as_dict, "cpu")
    assert flow2.metadata.n == 2


def test_conversion_errors():
    jl = ELEMENTS["rnvp"]()
    spec, leaves = jax_spec(jl), _leaves(jl)
    with pytest.raises(ValueError, match="leaves"):
        dt.chain_from_spec_and_leaves(spec, leaves[:-1], "cpu")
    bad = list(leaves)
    bad[0] = bad[0][:1]
    with pytest.raises(ValueError, match="shape"):
        dt.chain_from_spec_and_leaves(spec, bad, "cpu")
    bad = list(leaves)
    bad[0] = bad[0].astype(np.float64)
    with pytest.raises(TypeError, match="float32"):
        dt.chain_from_spec_and_leaves(spec, bad, "cpu")
    # the other base distributions and layer families load
    diag = element_from_spec(jax_spec(df.DiagNormal(
        jax.numpy.zeros(2), jax.numpy.ones(2))), "cpu")
    assert isinstance(diag, dt.DiagNormal) and diag.d == 2
    rqs = ELEMENTS["rqs"]()
    loaded = dt.chain_from_spec_and_leaves(jax_spec(rqs), _leaves(rqs), "cpu")
    assert isinstance(loaded, dt.RQSCouplingLayer) and loaded.n_bins == 3
    with pytest.raises(ValueError, match="unknown element"):
        element_from_spec({"type": "Nope"}, "cpu")
    with pytest.raises(TypeError, match="register"):
        element_spec(object())


def test_register_element_for_a_custom_layer(tmp_path):
    class Scale(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = torch.nn.Parameter(w)

    dt.register_element(Scale, lambda el: {"d": int(el.w.shape[0])},
                        lambda s, dev: Scale(torch.zeros(s["d"], device=dev)))
    el = Scale(torch.arange(3, dtype=torch.float32))
    dt.save_element(str(tmp_path / "el"), el)
    back = dt.load_element(str(tmp_path / "el"), device="cpu")
    assert isinstance(back, Scale)
    assert torch.equal(back.w, el.w)
    set_element_leaves(back, [np.ones(3, np.float32)])
    assert float(back.w.detach().sum()) == 3.0
