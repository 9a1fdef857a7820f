"""Shared helpers of the tests that hold the PyTorch port
(``densityflows_tpu_torch``) against the JAX package on the CPU.

Weights and inputs are made with numpy from a seed and handed to both sides:
the JAX objects are built first, their conditioner weights are overwritten
with numpy draws, and the port's modules are made from the JAX ``element_spec``
and the pytree leaves as numpy arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.ops.mlp import MLP as JaxMLP
from densityflows_tpu.utils.checkpoint import element_spec

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
