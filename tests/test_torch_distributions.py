"""The port's base distributions (``models/distributions.py``) against the
JAX package on the CPU: ``log_prob`` of each base, a flow's ``log_prob`` /
``sample`` / ``sample_sweep`` on each base and its routing (a non-standard
base takes ``chain_apply`` for the sweep, never ``chain_sample``), the
moments of the port's draws, NLL gradients against ``jax.grad``, and
checkpoints across the two packages in both directions.

Tolerance: ``TOL`` (2e-5), f32 on both sides summed in another order;
``BoxUniform``'s ``-inf`` rows are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.models.fused_train import trainable_leaves

from _torch_parity import TOL, inputs, mixed_chain, t, to_torch

D, N = 6, 2


def jax_bases(d=D):
    rng = np.random.default_rng(5)
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return {
        "standard": df.StandardNormal(d),
        "diag": df.DiagNormal(f(d) * 0.3, jnp.exp(f(d) * 0.2)),
        "mixture": df.GaussianMixture(f(4, d), jnp.exp(f(4, d) * 0.2),
                                      f(4)),
        "box": df.BoxUniform(jnp.full((d,), -1.5) + f(d) * 0.1,
                             jnp.full((d,), 1.5) + f(d) * 0.1),
    }


def meta():
    return df.MetaData("m", D, N, np.array([0.0, -1.0], np.float32),
                       np.array([1.0, 2.0], np.float32))


def tmeta():
    m = meta()
    return dt.MetaData(m.hash, m.d, m.n, m.theta_min, m.theta_max)


@pytest.fixture(scope="module")
def bases():
    return jax_bases()


@pytest.mark.parametrize("name", ["standard", "diag", "mixture", "box"])
def test_base_log_prob_equals_jax(bases, name):
    jb = bases[name]
    tb = to_torch(jb)
    z = np.random.default_rng(1).normal(size=(3, 40, D)).astype(np.float32)
    z[0, :5, 0] = 5.0         # five rows leave the box
    z[1, 3, 2] = np.nan       # a NaN row
    want = np.asarray(jb.log_prob(jnp.asarray(z)))
    got = tb.log_prob(t(z)).numpy()
    assert got.shape == want.shape == (3, 40)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    if name == "box":
        assert np.isneginf(want).sum() >= 5 and np.isneginf(got[1, 3])
    assert tb.d == D


@pytest.mark.parametrize("name", ["diag", "mixture", "box"])
def test_sampled_moments(bases, name):
    """Per-dimension means of 2^16 draws against the base's analytic mean
    (z ≤ 5), the same draws from the same seed, and the shape rule."""
    tb = to_torch(bases[name])
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    s = tb.sample(g(), (4, 1 << 14), "cpu")
    assert s.shape == (4, 1 << 14, D) and s.dtype == torch.float32
    assert torch.equal(s, tb.sample(g(), (4, 1 << 14), "cpu"))
    s = s.reshape(-1, D).double()
    if name == "diag":
        mean, var = tb.mean.double(), tb.scale.double() ** 2
    elif name == "box":
        mean = (tb.lo + tb.hi).double() / 2
        var = ((tb.hi - tb.lo).double() ** 2) / 12
    else:
        w = torch.softmax(tb.logits.double(), 0)[:, None]
        mu, sc = tb.means.double(), tb.scales.double()
        mean = (w * mu).sum(0)
        var = (w * (sc ** 2 + mu ** 2)).sum(0) - mean ** 2
    z = ((s.mean(0) - mean).abs() / (var / s.shape[0]).sqrt()).max()
    assert float(z) <= 5.0
    np.testing.assert_allclose(s.var(0).numpy(), var.numpy(), rtol=0.05)
    if name == "box":
        assert bool(((s >= tb.lo.double()) & (s <= tb.hi.double())).all())


def _flow_pair(base):
    chain = mixed_chain(D, N)
    jflow = df.Flow(chain, meta(), base)
    tflow = dt.Flow(to_torch(chain), tmeta(), to_torch(base), device="cpu")
    return jflow, tflow


@pytest.mark.parametrize("name", ["diag", "mixture", "box"])
def test_flow_log_prob_and_sampling_route(bases, name, monkeypatch):
    """log_prob equals the JAX flow's under every policy; under True a
    non-standard base takes ``chain_apply`` once per call (its plain version
    here) and never ``chain_sample``; the two policies draw the same base
    sample from the same seed and agree."""
    jflow, tflow = _flow_pair(bases[name])
    x, th = inputs(D, N, 64, 2)
    th = th * 2.0 - 0.5
    want = np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(th)))
    calls = []
    real = fc.run_chain

    def counting(*a, **k):
        calls.append(k.get("with_ldj"))
        return real(*a, **k)

    def no_sample(*a, **k):
        raise AssertionError("chain_sample ran for a non-standard base")

    monkeypatch.setattr(fc, "run_chain", counting)
    monkeypatch.setattr(fc, "run_chain_sample", no_sample)
    out = {}
    for mode in (True, False):
        dt.set_fused_kernels(mode)
        try:
            calls.clear()
            with torch.no_grad():
                lp = tflow.log_prob(x, th)
                s = tflow.sample((50,), (0.5, 0.5),
                                 generator=torch.Generator().manual_seed(7))
                sw = tflow.sample_sweep(th[:3], 20,
                                        generator=torch.Generator()
                                        .manual_seed(7))
            out[mode] = (lp, s, sw, list(calls))
        finally:
            dt.set_fused_kernels("auto")
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(lp.numpy()), fin)
        np.testing.assert_allclose(lp.numpy()[fin], want[fin], **TOL)
    assert out[True][3] == [True, False, False]
    assert out[False][3] == []
    for a, b in zip(out[True][1:3], out[False][1:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert out[True][1].shape == (50, D) and out[True][2].shape == (3, 20, D)
    # the draw is the base's, swept by the model's forward_
    with torch.no_grad():
        r = tflow.base.sample(torch.Generator().manual_seed(7), (50,), "cpu")
        want_s = fc.fold_layers(tflow.model, r,
                                tflow.prepare_theta((0.5, 0.5), (50,)),
                                "fwd", False)
    assert torch.equal(out[False][1], want_s)


def test_the_base_is_not_trained(bases):
    """The base's tensors are buffers on the flow's device, outside the
    model: training moves the model and leaves the base as it was."""
    base = to_torch(bases["mixture"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, D)).astype(np.float32)
    th = rng.uniform(size=(80, N)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    flow = dt.Flow(to_torch(mixed_chain(D, N)), data, base, device="cpu")
    assert list(flow.base.parameters()) == []
    assert all(b.device == flow.device for b in flow.base.buffers())
    ids = {id(p) for p in trainable_leaves(flow.model)}
    assert not ids & {id(b) for b in flow.base.buffers()}
    before = [b.clone() for b in flow.base.buffers()]
    w0 = [p.detach().clone() for p in trainable_leaves(flow.model)]
    dt.train(flow, data, epochs=1, batchsize=32, verbose=False,
             generator=torch.Generator().manual_seed(0))
    assert flow.trained_path == "torch" and np.isfinite(flow.train_loss[0])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 flow.base.buffers()))
    assert any(not torch.equal(a, p.detach()) for a, p in
               zip(w0, trainable_leaves(flow.model)))
    with pytest.raises(dt.UnsupportedFusedTrain, match="StandardNormal"):
        dt.train(flow, data, epochs=1, batchsize=32, verbose=False,
                 fused_kernel=True)


@pytest.mark.parametrize("name", ["diag", "mixture"])
def test_nll_gradients_equal_jax_grad(bases, name):
    chain = mixed_chain(D, N)
    jbase = bases[name]
    x, th = inputs(D, N, 48, 4)

    def jloss(c):
        return df.nll_loss(c, jbase, jnp.asarray(x), jnp.asarray(th))

    jl, jg = jax.value_and_grad(jloss)(chain)
    tchain = to_torch(chain)
    loss = dt.nll_loss(tchain, to_torch(jbase), t(x), t(th))
    leaves = trainable_leaves(tchain)
    grads = torch.autograd.grad(loss, [p for p in leaves if p.numel()])
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    from densityflows_tpu_torch.utils.checkpoint import element_leaves
    by_id = dict(zip([id(p) for p in leaves if p.numel()], grads))
    for leaf, jgrad in zip(element_leaves(tchain), jleaves):
        if id(leaf) in by_id:
            np.testing.assert_allclose(by_id[id(leaf)].numpy(), jgrad,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["diag", "mixture", "box"])
def test_checkpoints_across_packages(bases, name, tmp_path):
    """A JAX save_flow loads in the port with equal log_prob (-inf rows
    included), and a port save_flow loads in the JAX package."""
    x, th = inputs(D, N, 40, 6)
    base = bases[name]
    if name == "box":
        # a box around the middle of the latents: some rows fall outside
        z, _ = _flow_pair(base)[0].inverse(jnp.asarray(x), jnp.asarray(th))
        base = df.BoxUniform(jnp.percentile(z, 3, axis=0),
                             jnp.percentile(z, 97, axis=0))
    jflow, tflow = _flow_pair(base)
    df.save_flow(str(tmp_path / "j"), jflow)
    loaded = dt.load_flow(str(tmp_path / "j"), device="cpu")
    assert type(loaded.base).__name__ == type(jflow.base).__name__
    assert all(b.device == loaded.device for b in loaded.base.buffers())
    want = np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(th)))
    for f in (loaded, tflow):
        with torch.no_grad():
            got = f.log_prob(x, th).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)
    if name == "box":
        assert np.isneginf(want).any() and np.isfinite(want).any()
    dt.save_flow(str(tmp_path / "t"), tflow)
    back = df.load_flow(str(tmp_path / "t"))
    for a, b in zip(jax.tree_util.tree_leaves(back.base),
                    jax.tree_util.tree_leaves(jflow.base)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(back.log_prob(jnp.asarray(x), jnp.asarray(th))),
        np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(th))))
