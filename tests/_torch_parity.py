"""Shared helpers of the tests that hold the PyTorch port
(``densityflows_tpu_torch``) against the JAX package on the CPU.

Weights and inputs are made with numpy from a seed and handed to both sides:
the JAX objects are built first, their conditioner weights are overwritten
with numpy draws, and the port's modules are made from the JAX ``element_spec``
and the pytree leaves as numpy arrays.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.ops.mlp import MLP as JaxMLP
from densityflows_tpu.utils.checkpoint import element_spec

import _torch_cpu  # noqa: F401

# f32 on both sides, a few layers deep: products are summed in another order
TOL = dict(rtol=2e-5, atol=2e-5)


def randomize(tree, seed):
    """Overwrite every conditioner MLP's weights and biases in a JAX element
    with seeded numpy draws (scaled so exp(s) stays tame)."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if not isinstance(node, JaxMLP):
            return node
        ws = tuple(jnp.asarray(
            rng.normal(size=w.shape).astype(np.float32)
            * (0.7 / np.sqrt(w.shape[0]))) for w in node.weights)
        bs = tuple(jnp.asarray(
            rng.normal(size=b.shape).astype(np.float32) * 0.1)
            for b in node.biases)
        return JaxMLP(ws, bs, node.activation)

    return jax.tree_util.tree_map(
        fill, tree, is_leaf=lambda n: isinstance(n, JaxMLP))


def to_torch(el):
    """The port's counterpart of a JAX element, on the CPU."""
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(el)]
    return dt.chain_from_spec_and_leaves(element_spec(el), leaves, "cpu")


def inputs(d, n, rows, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, d)) * 0.5).astype(np.float32)
    theta = rng.uniform(size=(rows, n)).astype(np.float32)
    return x, theta


def t(a):
    return torch.as_tensor(np.asarray(a))


def mixed_chain(d=6, n=2, seed=0, hidden=16):
    """A JAX chain holding every fusable element type."""
    ks = jax.random.split(jax.random.key(seed), 5)
    rng = np.random.default_rng(seed)
    x_ref = rng.normal(size=(64, d)).astype(np.float32) * 2.0 + 0.5
    h = dict(hidden_dim_s=hidden, hidden_dim_t=hidden)
    half = list(range(d // 2))
    chain = df.flow_chain(
        df.coupling_layer(d, half, n=n, key=ks[0], **h),
        df.actnorm_layer(x_ref),
        df.coupling_block(d, None, n=n, key=ks[1], **h),
        df.permutation_layer(d, key=ks[2]),
        df.coupling_layer(d, list(range(d - 3, d)), n=n,
                          kind=df.NICECouplingLayer, key=ks[3],
                          hidden_dim_t=hidden),
        df.coupling_layer(d, half, n=n, key=ks[4], joint_conditioner=True,
                          max_log_scale=2.0, activation_s="tanh",
                          activation_t="tanh", **h),
        df.invertible_linear_layer(d, key=ks[2]),
        df.normalization_layer(x_ref, -1.0, 1.0),
    )
    return randomize(chain, seed + 100)


# -- training ---------------------------------------------------------------

# the JAX suite's own tolerance for a few epochs of training on two paths
# (tests/test_fused_train.py): float accumulation order through Adam
TRAIN_ATOL = 1e-4


def jax_epoch_perms(key, epochs, n):
    """The permutations the JAX package's train program draws:
    ``jax.random.permutation(k, n)`` for ``k`` in ``split(key, epochs)``."""
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, epochs)])


def cond_data(rows=137, d=5, n=1, seed=1):
    """The same small conditional data set for both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    if n:
        th = rng.uniform(-1, 2, size=(rows, n)).astype(np.float32)
        return (df.DataArrays.make(x, th, rng=0),
                dt.DataArrays.make(x, th, rng=0), x)
    return df.DataArrays.make(x, rng=0), dt.DataArrays.make(x, rng=0), x


def torch_flow(jflow, tdata):
    """The port's CPU flow with the weights of a JAX flow."""
    return dt.Flow(to_torch(jflow.model), tdata, device="cpu")


def assert_leaves_close(jtree, tmodel, atol, what=""):
    from densityflows_tpu_torch.utils.checkpoint import element_leaves

    jl = jax.tree_util.tree_leaves(jtree)
    tl = element_leaves(tmodel)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        if a.size:
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       atol=atol, err_msg=f"{what} leaf {i}")


def assert_opt_state_close(jstate, tmodel, tstate, atol):
    """optax.adam state against the port's AdamState, through the leaf
    order of opt_state.npz."""
    jl = [np.asarray(l) for l in jax.tree_util.tree_leaves(jstate)]
    tl = dt.adam_state_to_jax_leaves(tmodel, tstate)
    assert len(jl) == len(tl)
    assert int(jl[0]) == int(tl[0]) == tstate.count
    for a, b in zip(jl[1:], tl[1:]):
        assert a.shape == b.shape
        if a.size:
            np.testing.assert_allclose(b, a, atol=atol)


def _ks(n):
    return jax.random.split(jax.random.key(0), n)


H16 = dict(hidden_dim_s=16, hidden_dim_t=16)
H12 = dict(hidden_dim_s=12, hidden_dim_t=12)

# JAX chains of the kernel's envelope, as ``fn(data, x_ref)``
TRAIN_CHAINS = {
    "reference": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(3)[0], **H16),
        df.coupling_layer(d, [2, 3, 4], key=_ks(3)[1], **H16),
        df.coupling_layer(d, [4, 0, 1], key=_ks(3)[2], **H16),
        df.normalization_layer(x, -1.0, 1.0)),
    "nice": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], kind=df.NICECouplingLayer,
                          key=_ks(2)[0]),
        df.coupling_layer(d, [2, 3, 4], kind=df.NICECouplingLayer,
                          key=_ks(2)[1]),
        df.normalization_layer(x, -1.0, 1.0)),
    "joint": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], joint_conditioner=True,
                          hidden_dim_s=24, hidden_dim_t=24),
        df.coupling_layer(d, [2, 3, 4], key=_ks(2)[1], joint_conditioner=True,
                          hidden_dim_s=24, hidden_dim_t=24),
        df.normalization_layer(x, -1.0, 1.0)),
    "nobias_tanh": lambda d, x: df.flow_chain(
        df.coupling_block(d.num_dimensions, [0, 2, 4], n=1, key=_ks(2)[0],
                          activation_s="tanh", activation_t="tanh",
                          bias=False, hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0)),
    "sigmoid": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], activation_s="sigmoid",
                          activation_t="sigmoid", **H12),
        df.coupling_layer(d, [2, 3, 4], key=_ks(2)[1], joint_conditioner=True,
                          activation_s="sigmoid", activation_t="sigmoid",
                          **H12),
        df.normalization_layer(x, -1.0, 1.0)),
    "deep": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], n_sublayers_s=3,
                          n_sublayers_t=1, **H12),
        df.normalization_layer(x, -1.0, 1.0)),
    # a LOW clamp so the nonlinear region is exercised
    "clamped": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], max_log_scale=0.1,
                          **H16),
        df.coupling_layer(d, [2, 3, 4], key=_ks(2)[1], max_log_scale=0.5,
                          joint_conditioner=True, **H16),
        df.normalization_layer(x, -1.0, 1.0)),
    "no_norm": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], **H16),
        df.coupling_layer(d, [2, 3, 4], key=_ks(2)[1], **H16)),
    "permutation": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [1, 3, 4], key=_ks(3)[0], **H12),
        df.normalization_layer(x, -1.0, 1.0),
        df.permutation_layer([1, 0, 4, 3, 2]),
        df.coupling_layer(d, [0, 2, 4], key=_ks(3)[1], **H12),
        df.permutation_layer([4, 3, 2, 1, 0]),
        df.permutation_layer([2, 0, 1, 4, 3]),
        df.coupling_layer(d, [0, 1, 2], key=_ks(3)[2], joint_conditioner=True,
                          **H12)),
    "actnorm": lambda d, x: df.flow_chain(
        df.coupling_layer(d, [0, 1, 2], key=_ks(2)[0], **H12),
        df.permutation_layer([3, 1, 4, 0, 2]),
        df.actnorm_layer(x),
        df.coupling_layer(d, [1, 2, 3], key=_ks(2)[1], joint_conditioner=True,
                          **H12),
        df.normalization_layer(x, -1.0, 1.0)),
}


class _FakeCuda:
    type = "cuda"


def fake_cuda(flow, monkeypatch):
    """Make ``flow`` claim a CUDA device (there is no card here) while the
    plain program's arrays stay on the CPU: ``train``'s "auto" then tries the
    whole-run kernel and records its decline."""
    dm = sys.modules["densityflows_tpu_torch.data"]
    flow.device = _FakeCuda()
    # every host → device copy of train() (the rows, θ, the splits'
    # indices) goes through the data module's one site
    monkeypatch.setattr(dm, "_as_tensor",
                        lambda a, device: torch.as_tensor(a))
