"""Precision and memory options of the PyTorch port against the JAX package
on the CPU: ``remat`` and ``mixed_precision`` (``train.py``),
``cast_conditioners`` (``models/layers.py``), bfloat16 leaves in checkpoints
and bfloat16-stored conditioners through the kernels' packers.

The cases of the JAX suite's ``tests/test_remat.py`` and
``tests/test_mixed_precision.py`` are ported under their names, each also
held against the JAX function on the same inputs and leaves.

Gates. ``remat`` changes no arithmetic: its gradients equal the plain ones
at 1e-4 (in practice bit for bit). bfloat16 changes every product, so the
port's bfloat16 results are held to JAX's bfloat16 results by a gate taken
from JAX's own bfloat16 against its float32 on the same inputs: the loss
within a quarter of |L_bf16 − L_f32| of JAX's, so that a port computing
in float32 fails it (measured 0 to 0.021 of that gap over three seeds of
random weights), and there different from the port's own float32 loss (at
the near-identity init both packages' bfloat16 and float32 losses are
equal, and the gate is equality);
every gradient within twice JAX's largest bfloat16 − float32 gradient gap
(one bfloat16 ulp either way; measured 0.57–1.14 of that gap over four
seeds); the training histories at the JAX suite's own 0.05 (1 + |L|) of
JAX's bfloat16 run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import fused_chain as JF
from densityflows_tpu.models.layers import cast_conditioners as jax_cast
from densityflows_tpu.ops import pallas_chain as JP
from densityflows_tpu.train import make_train_step as jax_step
from densityflows_tpu.train import masked_nll_loss as jax_loss
from densityflows_tpu_torch.models import fused_chain as TF
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.models.layers import _cast_in_graph
from densityflows_tpu_torch.train import _loss_inverse
from densityflows_tpu_torch.utils.checkpoint import element_leaves

from _torch_parity import jax_epoch_perms, randomize, to_torch

ATOL = 1e-4


def _grads_by_leaf(model, grads_of):
    """Gradients aligned with ``element_leaves`` (None for buffers)."""
    pos = {id(p): g for p, g in grads_of}
    return [pos.get(id(t)) for t in element_leaves(model)]


def _port_grads(model, base, x, th, mask, **kw):
    leaves = list(model.parameters())
    with torch.enable_grad():
        loss = dt.masked_nll_loss(model, base, x, th, mask, **kw)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), _grads_by_leaf(model, zip(leaves, g))


def _max_gap(port, jax_grads):
    return max(float(np.abs(a.numpy() - np.asarray(b)).max())
               for a, b in zip(port, jax_grads)
               if a is not None and np.asarray(b).size)


# -- remat (JAX tests/test_remat.py) ---------------------------------------------

def _setup(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(200, 3)) * [1.0, 0.5, 2.0]).astype(np.float32)
    jd = df.DataArrays.make(x, rng=0)
    chain = randomize(df.flow_chain(
        df.coupling_layer(jd, [0, 1], key=jax.random.key(0)),
        df.coupling_layer(jd, [1, 2], key=jax.random.key(1)),
        df.normalization_layer(x, -1.0, 1.0),
    ), seed + 40)
    return chain, jd, dt.DataArrays.make(x, rng=0), x


def test_remat_gradients_match_plain():
    chain, _, _, x = _setup()
    model = to_torch(chain)
    base = dt.StandardNormal(3)
    xb, th, mask = torch.as_tensor(x[:64]), torch.zeros(64, 0), torch.ones(64)
    l_plain, g_plain = _port_grads(model, base, xb, th, mask)
    l_remat, g_remat = _port_grads(model, base, xb, th, mask, remat=True)
    assert l_plain == l_remat
    for a, b in zip(g_plain, g_remat):
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL)
    jb = df.StandardNormal(3)
    jg = jax.grad(lambda m: jax_loss(m, jb, jnp.asarray(x[:64]),
                                     jnp.zeros((64, 0)), jnp.ones((64,)),
                                     remat=True))(chain)
    assert _max_gap(g_remat, jax.tree_util.tree_leaves(jg)) < ATOL


def test_remat_on_embedded_chain():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(100, 2)).astype(np.float32)
    raw = rng.normal(size=(100, 4)).astype(np.float32)
    inner = df.flow_chain(df.coupling_layer(2, [0], n=3,
                                            key=jax.random.key(0)))
    jmodel = randomize(df.embed_conditions(inner, 4, 3,
                                           key=jax.random.key(1)), 7)
    model = to_torch(jmodel)
    base = dt.StandardNormal(2)
    xb, th, mask = (torch.as_tensor(x[:32]), torch.as_tensor(raw[:32]),
                    torch.ones(32))
    _, g_plain = _port_grads(model, base, xb, th, mask)
    _, g_remat = _port_grads(model, base, xb, th, mask, remat=True)
    for a, b in zip(g_plain, g_remat):
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL)
    jg = jax.grad(lambda m: jax_loss(m, df.StandardNormal(2),
                                     jnp.asarray(x[:32]),
                                     jnp.asarray(raw[:32]), jnp.ones((32,)),
                                     remat=True))(jmodel)
    assert _max_gap(g_remat, jax.tree_util.tree_leaves(jg)) < ATOL


def test_remat_train_end_to_end():
    chain, jd, td, x = _setup(2)
    jflow = df.Flow(chain, jd)
    flow = dt.Flow(to_torch(chain), td, device="cpu")
    df.train(jflow, jd, epochs=4, verbose=False, key=jax.random.key(2),
             remat=True)
    perms = jax_epoch_perms(jax.random.key(2), 4, len(jd.partition.training))
    dt.train(flow, td, epochs=4, verbose=False, remat=True,
             _epoch_perms=perms)
    assert np.all(np.isfinite(flow.training_loss))
    assert flow.training_loss[-1] < flow.training_loss[0]
    assert flow.trained_path == "torch"
    np.testing.assert_allclose(flow.train_loss, jflow.train_loss, atol=ATOL)
    np.testing.assert_allclose(flow.valid_loss, jflow.valid_loss, atol=ATOL)


def test_remat_streaming_step():
    chain, _, _, x = _setup(3)
    model = to_torch(chain)
    step = dt.make_train_step(dt.adam(1e-3), remat=True)
    state = dt.adam(1e-3).init(FT.trainable_leaves(model))
    model, state, loss = step(model, state, dt.StandardNormal(3),
                              torch.as_tensor(x[:64]), torch.zeros(64, 0),
                              torch.ones(64))
    assert np.isfinite(float(loss)) and state.count == 1
    jopt = optax.adam(1e-3)
    _, _, jloss = jax_step(jopt, remat=True)(
        chain, jopt.init(chain), df.StandardNormal(3), jnp.asarray(x[:64]),
        jnp.zeros((64, 0)), jnp.ones((64,)))
    assert abs(float(loss) - float(jloss)) < ATOL


def test_remat_and_mixed_precision_route_to_the_plain_program():
    """Under "auto" the options record the plain program; forcing the
    kernel with either raises, as the JAX package does."""
    chain, _, td, _ = _setup(4)
    for kw in (dict(remat=True), dict(mixed_precision=True)):
        flow = dt.Flow(to_torch(chain), td, device="cpu")
        dt.train(flow, td, epochs=1, verbose=False, **kw,
                 generator=torch.Generator().manual_seed(0))
        assert flow.trained_path == "torch"
        with pytest.raises(ValueError, match="remat/mixed_precision"):
            dt.train(flow, td, epochs=1, verbose=False, fused_kernel=True,
                     **kw)


# -- mixed precision (JAX tests/test_mixed_precision.py) --------------------------

def _tiny_flow(jd, td, key=None):
    ks = jax.random.split(key if key is not None else jax.random.key(0), 2)
    x = np.asarray(jd.x)
    chain = df.flow_chain(
        df.coupling_layer(jd, [0, 1], hidden_dim_s=8, hidden_dim_t=8,
                          key=ks[0]),
        df.coupling_layer(jd, [2, 3], hidden_dim_s=8, hidden_dim_t=8,
                          key=ks[1]),
        df.normalization_layer(x, -1.0, 1.0),
    )
    return df.Flow(chain, jd), dt.Flow(to_torch(chain), td, device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    theta = rng.uniform(-1, 1, size=(512, 1)).astype(np.float32)
    return df.DataArrays.make(x, theta, rng=0), dt.DataArrays.make(
        x, theta, rng=0)


def _float_leaves(model):
    return [t for t in element_leaves(model) if t.is_floating_point()]


def test_cast_conditioners_targets_nets_only(data):
    jflow, flow = _tiny_flow(*data)
    model = flow.model
    cast = dt.cast_conditioners(model, torch.bfloat16)
    for layer in cast.layers[:2]:
        assert all(w.dtype == torch.bfloat16 for w in layer.s_net.weights)
        assert all(w.dtype == torch.bfloat16 for w in layer.t_net.weights)
        assert all(b.dtype == torch.bfloat16 for b in layer.t_net.biases)
    norm0, norm1 = model.layers[-1], cast.layers[-1]
    for a, b in zip(_float_leaves(norm0), _float_leaves(norm1)):
        assert b.dtype == a.dtype == torch.float32
    # the caller's model is untouched
    assert all(w.dtype == torch.float32
               for w in model.layers[0].s_net.weights)
    # the same values as JAX's cast, bit for bit
    jcast = jax_cast(jflow.model, jnp.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(jcast), element_leaves(cast)):
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(
            b.detach().float().numpy(), np.asarray(a).astype(np.float32))


def test_cast_conditioners_covers_made_and_glow():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    chain = dt.flow_chain(
        dt.maf_layer(4, n=0, hidden_dim=8, generator=g, device="cpu"),
        dt.invertible_linear_layer(4, generator=g, device="cpu"),
        dt.actnorm_layer(x, device="cpu"),
    )
    cast = dt.cast_conditioners(chain, torch.bfloat16)
    assert all(w.dtype == torch.bfloat16 for w in cast.layers[0].net.weights)
    for layer in cast.layers[1:]:
        for a in _float_leaves(layer):
            assert a.dtype == torch.float32
    # a MADE net computes in bfloat16 and hands float32 back
    z, ldj = cast.inverse(torch.as_tensor(x), torch.zeros(64, 0))
    assert z.dtype == ldj.dtype == torch.float32
    assert bool(torch.isfinite(z).all())


# the port's bfloat16 loss against JAX's: this share of JAX's own
# bfloat16 − float32 gap
LOSS_GATE_SHARE = 0.25


def _loss_gate(jflow, x, th, mask):
    """JAX's bfloat16 loss and gradients, and the gates from its own
    bfloat16 − float32 gap."""
    fn = lambda mp: jax.value_and_grad(  # noqa: E731
        lambda m: jax_loss(m, jflow.base, x, th, mask, mixed_precision=mp))(
            jflow.model)
    (lb, gb), (lf, gf) = fn(True), fn(False)
    gb, gf = jax.tree_util.tree_leaves(gb), jax.tree_util.tree_leaves(gf)
    g_gap = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(gb, gf) if np.asarray(a).size)
    return (float(lb), gb, LOSS_GATE_SHARE * abs(float(lb) - float(lf)),
            2.0 * g_gap)


def test_mixed_precision_loss_and_grads_stay_f32(data):
    jd, td = data
    jflow, flow = _tiny_flow(jd, td)
    xn, thn = jd.normalized_training_data(jflow.metadata)
    x, th = torch.as_tensor(xn[:64]), torch.as_tensor(thn[:64])
    mask = torch.ones(64)
    leaves = list(flow.model.parameters())
    with torch.enable_grad():
        loss = dt.masked_nll_loss(flow.model, flow.base, x, th, mask,
                                  mixed_precision=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss.detach()))
    for g in grads:
        assert g is None or g.dtype == torch.float32
    loss_f32 = dt.masked_nll_loss(flow.model, flow.base, x, th, mask).detach()
    assert abs(float(loss.detach()) - float(loss_f32)) < 0.05 * (
        1.0 + abs(float(loss_f32)))
    # against JAX's bfloat16 loss and gradients, at the gate its own
    # bfloat16 − float32 gap sets
    lb, gb, l_gate, g_gate = _loss_gate(
        jflow, jnp.asarray(xn[:64]), jnp.asarray(thn[:64]), jnp.ones((64,)))
    assert abs(float(loss.detach()) - lb) <= l_gate
    port = _grads_by_leaf(flow.model, zip(leaves, grads))
    assert _max_gap(port, gb) <= g_gate


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mixed_precision_loss_and_grads_match_jax_randomized(data, seed):
    """Random weights (not the near-identity init): the same gate."""
    jd, td = data
    jflow, _ = _tiny_flow(jd, td)
    jflow = df.Flow(randomize(jflow.model, seed + 10), jd)
    model = to_torch(jflow.model)
    xn, thn = jd.normalized_training_data(jflow.metadata)
    lb, gb, l_gate, g_gate = _loss_gate(
        jflow, jnp.asarray(xn[:64]), jnp.asarray(thn[:64]), jnp.ones((64,)))
    loss, grads = _port_grads(model, dt.StandardNormal(4),
                              torch.as_tensor(xn[:64]),
                              torch.as_tensor(thn[:64]), torch.ones(64),
                              mixed_precision=True)
    loss_f32, _ = _port_grads(model, dt.StandardNormal(4),
                              torch.as_tensor(xn[:64]),
                              torch.as_tensor(thn[:64]), torch.ones(64))
    assert abs(loss - lb) <= l_gate
    assert loss != loss_f32
    assert _max_gap(grads, gb) <= g_gate


def test_train_step_mixed_precision_keeps_f32_params(data):
    jd, td = data
    jflow, flow = _tiny_flow(jd, td)
    opt = dt.adam(1e-3)
    step = dt.make_train_step(opt, mixed_precision=True)
    xn, thn = jd.normalized_training_data(jflow.metadata)
    x, th = torch.as_tensor(xn[:64]), torch.as_tensor(thn[:64])
    model, state, loss = step(flow.model, opt.init(
        FT.trainable_leaves(flow.model)), flow.base, x, th, torch.ones(64))
    assert np.isfinite(float(loss))
    for a in _float_leaves(model):
        assert a.dtype == torch.float32
    for a in state.mu + state.nu:
        assert a.dtype == torch.float32
    _, _, l_gate, _ = _loss_gate(jflow, jnp.asarray(xn[:64]),
                                 jnp.asarray(thn[:64]), jnp.ones((64,)))
    jopt = optax.adam(1e-3)    # the step donates the model: gate first
    _, _, jloss = jax_step(jopt, mixed_precision=True)(
        jflow.model, jopt.init(jflow.model), jflow.base,
        jnp.asarray(xn[:64]), jnp.asarray(thn[:64]), jnp.ones((64,)))
    assert abs(float(loss) - float(jloss)) <= l_gate


def test_train_mixed_precision_converges_like_f32(data):
    jd, td = data
    nlls = {}
    perms = jax_epoch_perms(jax.random.key(3), 15,
                            len(jd.partition.training))
    for mp in (False, True):
        jflow, flow = _tiny_flow(jd, td, key=jax.random.key(7))
        dt.train(flow, td, dt.adam(1e-2), epochs=15, verbose=False,
                 mixed_precision=mp, _epoch_perms=perms)
        assert len(flow.train_loss) == 15
        assert np.all(np.isfinite(flow.train_loss))
        nlls[mp] = flow.train_loss[-1]
        if mp:
            df.train(jflow, jd, optax.adam(1e-2), epochs=15, verbose=False,
                     key=jax.random.key(3), mixed_precision=True)
            # the JAX suite's own gate between bfloat16 and float32 runs
            gap = np.abs(np.asarray(flow.train_loss)
                         - np.asarray(jflow.train_loss))
            assert np.all(gap < 0.05 * (1.0 + np.abs(jflow.train_loss)))
    assert abs(nlls[True] - nlls[False]) < 0.15 * (1.0 + abs(nlls[False]))
    _, first = _tiny_flow(jd, td, key=jax.random.key(7))
    with torch.no_grad():
        z, ldj = first.model.inverse(torch.as_tensor(np.asarray(td.x[:64])),
                                     torch.as_tensor(
                                         np.asarray(td.theta[:64])))
        init_nll = -float((first.base.log_prob(z) + ldj).mean())
    assert nlls[True] < init_nll


def test_nan_row_through_the_bf16_loss_keeps_the_jax_nan_pattern(data):
    jd, td = data
    jflow, _ = _tiny_flow(jd, td)
    jflow = df.Flow(randomize(jflow.model, 21), jd)
    model = to_torch(jflow.model)
    xn, thn = jd.normalized_training_data(jflow.metadata)
    x = np.array(xn[:32])
    x[[3, 17], 1] = np.nan
    jcast = jax_cast(jflow.model, jnp.bfloat16)
    jz, jldj = jcast.inverse(jnp.asarray(x), jnp.asarray(thn[:32]))
    jlp = np.asarray(jflow.base.log_prob(jz) + jldj)
    with torch.no_grad():
        z, ldj = _loss_inverse(model, torch.as_tensor(x),
                               torch.as_tensor(thn[:32]),
                               mixed_precision=True)
        lp = (dt.StandardNormal(4).log_prob(z) + ldj).numpy()
    np.testing.assert_array_equal(np.isnan(lp), np.isnan(jlp))
    assert np.isnan(lp).sum() == 2
    ok = ~np.isnan(jlp)
    # per row, JAX's own bfloat16 − float32 gap on the same rows
    jz32, jldj32 = jflow.model.inverse(jnp.asarray(x), jnp.asarray(thn[:32]))
    gap = np.abs(jlp - np.asarray(jflow.base.log_prob(jz32) + jldj32))
    assert np.all(np.abs(lp - jlp)[ok] <= np.maximum(gap[ok], 1e-5) * 2)
    with torch.no_grad():
        loss = dt.masked_nll_loss(model, dt.StandardNormal(4),
                                  torch.as_tensor(x),
                                  torch.as_tensor(thn[:32]), torch.ones(32),
                                  mixed_precision=True)
    assert np.isnan(float(loss)) and np.isnan(float(jax_loss(
        jflow.model, jflow.base, jnp.asarray(x), jnp.asarray(thn[:32]),
        jnp.ones((32,)), mixed_precision=True)))


def test_cast_in_graph_shares_the_master_parameters(data):
    jd, td = data
    _, flow = _tiny_flow(jd, td)
    view = _cast_in_graph(flow.model)
    w = flow.model.layers[0].s_net.weights[0]
    v = view.layers[0].s_net.weights[0]
    assert v.dtype == torch.bfloat16 and w.dtype == torch.float32
    assert view.layers[-1].x_min is flow.model.layers[-1].x_min
    assert not isinstance(v, torch.nn.Parameter)


# -- bfloat16 in checkpoints and through the kernels' packers -------------------

def test_jax_written_bf16_checkpoint_loads_bit_for_bit(data, tmp_path):
    """JAX writes a bfloat16 leaf as 2 raw bytes (``|V2``); the port reads
    it through its spec's dtype and writes the same bytes back. (JAX's own
    ``load_flow`` cannot read such a leaf: a fault of the reference,
    recorded in ROADMAP.md.)"""
    jd, td = data
    jflow, _ = _tiny_flow(jd, td)
    jcast = df.Flow(jax_cast(randomize(jflow.model, 3), jnp.bfloat16), jd)
    df.save_flow(str(tmp_path / "j"), jcast)
    flow = dt.load_flow(str(tmp_path / "j"), device="cpu")
    jl = jax.tree_util.tree_leaves(jcast.model)
    tl = element_leaves(flow.model)
    n_bf16 = 0
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    assert n_bf16 == 24   # 2 couplings x 2 nets x 3 weights + 3 biases
    dt.save_flow(str(tmp_path / "t"), flow)
    with np.load(tmp_path / "j" / "model" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "model" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    back = dt.load_flow(str(tmp_path / "t"), device="cpu")
    for a, b in zip(element_leaves(flow.model), element_leaves(back.model)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port's cast of the same f32 weights gives the same bits
    port_cast = dt.cast_conditioners(to_torch(randomize(jflow.model, 3)))
    for a, b in zip(element_leaves(port_cast), tl):
        assert torch.equal(a, b)


def test_bf16_chain_log_prob_on_the_chain_path_matches_jax():
    """A bfloat16-stored chain on the chain route (its plain version on the
    CPU: the weights upcast as the packer takes them) against JAX's upcast
    chain kernel in interpret mode."""
    rng = np.random.default_rng(2)
    d, n = 5, 2
    x_ref = rng.normal(size=(64, d)).astype(np.float32)
    ks = jax.random.split(jax.random.key(11), 3)
    jchain = jax_cast(randomize(df.flow_chain(
        df.coupling_layer(d, [0, 1], n=n, key=ks[0], hidden_dim_s=12,
                          hidden_dim_t=12),
        df.coupling_layer(d, [2, 3, 4], n=n, key=ks[1],
                          joint_conditioner=True, hidden_dim_s=12,
                          hidden_dim_t=12),
        df.coupling_layer(d, [1, 3], n=n, key=ks[2],
                          kind=df.NICECouplingLayer),
        df.normalization_layer(x_ref, -1.0, 1.0)), 5), jnp.bfloat16)
    chain = to_torch(jchain)
    assert chain.layers[0].s_net.weights[0].dtype == torch.bfloat16
    x = (rng.normal(size=(37, d)) * 0.5).astype(np.float32)
    th = rng.uniform(size=(37, n)).astype(np.float32)
    for dirn in ("inv", "fwd"):
        plan, params = JF._plan_params(jchain, dirn)
        want = JP.run_chain(plan, params, jnp.asarray(x), jnp.asarray(th),
                            with_ldj=True, interpret=True)
        dt.set_fused_kernels(True)
        try:
            got = TF.maybe_apply_fused(chain, torch.as_tensor(x),
                                       torch.as_tensor(th), dirn, True)
        finally:
            dt.set_fused_kernels("auto")
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   np.asarray(want[0]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[1].detach().numpy(),
                                   np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    # the packed parameters are the bfloat16 weights upcast, exactly
    _, params = TF._plan_params(chain, "inv")
    assert all(p.dtype == torch.float32 for p in params)
    _, jparams = JF._plan_params(jchain, "inv")
    for a, b in zip(params, jparams):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # another dtype still raises by name
    with pytest.raises(TypeError, match="float32 only"):
        TF._require_kernel_limits(chain.double(), d, n, torch.device("cpu"))


def test_bf16_conditioners_through_the_train_and_coupling_packers(data):
    jd, td = data
    _, flow = _tiny_flow(jd, td)
    chain = dt.cast_conditioners(flow.model)
    ref = dt.cast_conditioners(chain, torch.float32)
    got, want = FT.chain_train_fold(chain), FT.chain_train_fold(ref)
    assert got[0] == want[0]
    for a, b in zip(got[2], want[2]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    # the per-layer coupling op upcasts inside, differentiably
    layer = chain.layers[0]
    x = torch.as_tensor(np.asarray(td.x[:16]), dtype=torch.float32)
    th = torch.rand(16, 1, generator=torch.Generator().manual_seed(0))
    dt.set_fused_kernels(True)
    try:
        with torch.enable_grad():
            y, ldj = layer.inverse(x, th)
            y.sum().backward()
        y_ref, ldj_ref = ref.layers[0].inverse(x, th)
    finally:
        dt.set_fused_kernels("auto")
    torch.testing.assert_close(y, y_ref.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj, ldj_ref.detach(), rtol=1e-5, atol=1e-5)
    assert layer.s_net.weights[0].grad.dtype == torch.bfloat16
    with pytest.raises(dt.UnsupportedFusedTrain, match="float32 or bfloat16"):
        FT.chain_train_fold(dt.cast_conditioners(flow.model, torch.float64))
