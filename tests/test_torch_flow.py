"""The serving slice of the PyTorch port as a whole, against the JAX package
on the CPU: a JAX ``Flow`` saved with ``save_flow`` and loaded by the port's
``load_flow``; ``log_prob`` in array and grid form, ``forward``,
``inverse``, ``sample`` / ``sample_sweep`` with injected noise, every
``prepare_theta`` rule and its errors; a flow saved by the port loading in
JAX. Tolerance 1e-4 abs+rel on chain outputs and log-probs (f32 on both
sides through 8 elements, sums in another order; |log p| is O(10))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import layers as JL
from densityflows_tpu_torch.models import flow as TFLOW

from _torch_parity import inputs, mixed_chain, randomize, t

TOL = dict(rtol=1e-4, atol=1e-4)
D, N = 6, 2
THETA_MIN = np.array([-1.0, 0.0], np.float32)
THETA_MAX = np.array([3.0, 2.0], np.float32)


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """(JAX flow, the port's flow loaded from the JAX checkpoint)."""
    meta = df.MetaData("h", D, N, THETA_MIN, THETA_MAX)
    jflow = df.Flow(mixed_chain(), meta, train_loss=[3.0, 2.5],
                    valid_loss=[3.1])
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_flow")
    df.save_flow(path, jflow)
    return jflow, dt.load_flow(path, device="cpu"), path


@pytest.fixture(autouse=True)
def modes(request):
    JL.set_fused_kernels(False)
    dt.set_fused_kernels(getattr(request, "param", "auto"))
    yield
    JL.set_fused_kernels("auto")
    dt.set_fused_kernels("auto")


def _raw_theta(rows, seed=0):
    rng = np.random.default_rng(seed)
    return (THETA_MIN + (THETA_MAX - THETA_MIN)
            * rng.uniform(size=(rows, N))).astype(np.float32)


def test_loaded_flow_carries_metadata_and_histories(flows):
    jflow, tflow, _ = flows
    assert (tflow.metadata.d, tflow.metadata.n, tflow.metadata.hash) == \
        (D, N, "h")
    np.testing.assert_array_equal(tflow.metadata.theta_max, THETA_MAX)
    assert tflow.train_loss == [3.0, 2.5] and tflow.validation_loss == [3.1]
    assert tflow.training_loss is tflow.train_loss
    assert isinstance(tflow.base, dt.StandardNormal) and tflow.base.d == D
    assert tflow.summarize() == jflow.summarize()
    assert dt.summarize(tflow) == tflow.summarize()
    assert tflow.device == torch.device("cpu")


# run once on the per-layer path and once through the whole-chain plan
# (on the CPU the kernel wrappers execute their plain versions)
@pytest.mark.parametrize("modes", ["auto", True], indirect=True)
def test_log_prob_forward_inverse_match_jax(flows, modes):
    jflow, tflow, _ = flows
    x, _ = inputs(D, N, 33, 1)
    theta = _raw_theta(33)
    np.testing.assert_allclose(
        tflow.log_prob(x, theta).detach().numpy(),
        np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(theta))), **TOL)
    # one condition vector for every row
    np.testing.assert_allclose(
        tflow.log_prob(x, (0.5, 1.0)).detach().numpy(),
        np.asarray(jflow.log_prob(jnp.asarray(x), (0.5, 1.0))), **TOL)
    np.testing.assert_allclose(
        tflow.prob(x, (0.5, 1.0)).detach().numpy(),
        np.asarray(jflow.prob(jnp.asarray(x), (0.5, 1.0))), rtol=1e-3,
        atol=1e-12)
    for name in ("forward", "inverse"):
        jy, jl = getattr(jflow, name)(jnp.asarray(x), jnp.asarray(theta))
        ty, tl = getattr(tflow, name)(x, theta)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(
        tflow.predict(x, theta).detach().numpy(),
        np.asarray(jflow.predict(jnp.asarray(x), jnp.asarray(theta))), **TOL)
    z, _ = tflow.backward(x, theta)
    back, _ = tflow.forward(z, theta)
    np.testing.assert_allclose(back.detach().numpy(), x, rtol=1e-3, atol=1e-3)
    assert tflow.logpdf.__func__ is tflow.log_prob.__func__


def test_log_prob_batch_dims(flows):
    jflow, tflow, _ = flows
    x = inputs(D, N, 12, 2)[0].reshape(3, 4, D)
    theta = _raw_theta(12).reshape(3, 4, N)
    got = tflow.log_prob(x, theta)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(theta))), **TOL)


@pytest.mark.parametrize("grid_chunk", [65536, 7])
def test_log_prob_grid_form_matches_jax(grid_chunk):
    d = 3
    chain = randomize(df.flow_chain(
        df.coupling_layer(d, [0], n=1, hidden_dim_s=8, hidden_dim_t=8),
        df.coupling_layer(d, [1, 2], n=1, hidden_dim_s=8, hidden_dim_t=8,
                          key=jax.random.key(1))), 5)
    meta = df.MetaData("", d, 1, np.array([0.0]), np.array([2.0]))
    jflow = df.Flow(chain, meta)
    from _torch_parity import to_torch
    tflow = dt.Flow(to_torch(chain),
                    dt.MetaData("", d, 1, np.array([0.0]), np.array([2.0])),
                    device="cpu")
    vecs = (np.linspace(-1, 1, 4).astype(np.float32),
            np.linspace(-0.5, 0.5, 3).astype(np.float32),
            np.linspace(0, 1, 5).astype(np.float32))
    want = np.asarray(jflow.log_prob(vecs, (1.0,)))
    got = tflow.log_prob(vecs, (1.0,), grid_chunk=grid_chunk)
    assert tuple(got.shape) == (4, 3, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    with pytest.raises(ValueError):
        tflow.log_prob(vecs[:2], (1.0,))
    with pytest.raises(ValueError):
        tflow.log_prob(vecs, None)


@pytest.mark.parametrize("modes", ["auto", True], indirect=True)
def test_sample_and_sweep_with_injected_noise_match_jax(flows, modes,
                                                        monkeypatch):
    """Both packages fold the same base draw: the port's noise (a seeded
    ``torch.randn``) is handed to the JAX chain."""
    jflow, tflow, _ = flows
    gen = lambda: torch.Generator().manual_seed(11)
    noise = torch.randn(40, D, generator=gen()).numpy()

    def jax_fold(theta_rows):
        th = df.normalize_input(jnp.asarray(theta_rows),
                                jnp.asarray(THETA_MIN), jnp.asarray(THETA_MAX))
        return np.asarray(jflow.model.forward_(jnp.asarray(noise), th))

    got = tflow.sample((40,), (0.5, 1.0), generator=gen())
    assert got.shape == (40, D)
    np.testing.assert_allclose(
        got.detach().numpy(),
        jax_fold(np.tile(np.array([[0.5, 1.0]], np.float32), (40, 1))), **TOL)
    # per-draw θ, multi-dim draw shape
    theta = _raw_theta(40, 3)
    got = tflow.sample((8, 5), theta.reshape(8, 5, N), generator=gen())
    assert got.shape == (8, 5, D)
    np.testing.assert_allclose(got.detach().numpy().reshape(40, D),
                               jax_fold(theta), **TOL)
    assert tflow.sample(4, (0.5, 1.0), generator=gen()).shape == (4, D)
    # sweep: G θ rows × n_per_theta draws
    thetas = _raw_theta(8, 4)
    got = tflow.sample_sweep(thetas, 5, generator=gen())
    assert got.shape == (8, 5, D)
    np.testing.assert_allclose(got.detach().numpy().reshape(40, D),
                               jax_fold(np.repeat(thetas, 5, axis=0)), **TOL)
    with pytest.raises(ValueError):
        tflow.sample_sweep(thetas[:, :1], 5)
    # same generator state, same draws; another seed, other draws
    a = tflow.sample((6,), (0.5, 1.0), generator=gen())
    b = tflow.sample((6,), (0.5, 1.0), generator=gen())
    c = tflow.sample((6,), (0.5, 1.0),
                     generator=torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tflow.sample((3,), (0.5, 1.0)).shape == (3, D)  # no generator


def test_prepare_theta_rules_and_errors(flows):
    jflow, tflow, _ = flows
    for theta in [(0.5, 1.0), [0.5, 1.0], np.array([0.5, 1.0], np.float32),
                  _raw_theta(5), torch.as_tensor(_raw_theta(5))]:
        got = tflow.prepare_theta(theta, (5,))
        want = jflow.prepare_theta(
            jnp.asarray(theta) if isinstance(theta, torch.Tensor) else theta,
            (5,))
        assert tuple(got.shape) == (5, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # theta=None on a conditional flow raises
    with pytest.raises(ValueError, match="conditional"):
        tflow.prepare_theta(None, (5,))
    with pytest.raises(ValueError, match="conditional"):
        tflow.log_prob(inputs(D, N, 5, 0)[0])
    # a 1-D θ is ALWAYS one condition vector: wrong length raises, even
    # when it equals the batch size
    with pytest.raises(ValueError, match="2 entries"):
        tflow.prepare_theta(np.zeros(5, np.float32), (5,))
    with pytest.raises(ValueError, match="2 entries"):
        tflow.prepare_theta(0.5, (5,))
    with pytest.raises(ValueError, match="shape"):
        tflow.prepare_theta(_raw_theta(4), (5,))
    with pytest.raises(ValueError, match="shape"):
        tflow.prepare_theta(_raw_theta(5).reshape(5, 1, N), (5,))


def test_unconditional_flow_and_scalar_theta():
    from _torch_parity import to_torch
    chain = mixed_chain(d=5, n=0, seed=6)
    meta = df.MetaData("", 5, 0, np.zeros(0), np.zeros(0))
    jflow = df.Flow(chain, meta)
    tflow = dt.Flow(to_torch(chain),
                    dt.MetaData("", 5, 0, np.zeros(0), np.zeros(0)),
                    device="cpu")
    x, _ = inputs(5, 0, 9, 0)
    np.testing.assert_allclose(tflow.log_prob(x).detach().numpy(),
                               np.asarray(jflow.log_prob(jnp.asarray(x))),
                               **TOL)
    assert tflow.prepare_theta(None, (3, 2)).shape == (3, 2, 0)
    assert tflow.sample((7,), generator=torch.Generator().manual_seed(0)
                        ).shape == (7, 5)
    # n = 1: a Python scalar is one condition vector
    chain1 = randomize(df.flow_chain(df.coupling_layer(
        3, [0], n=1, hidden_dim_s=4, hidden_dim_t=4)), 1)
    meta1 = dict(hash="", d=3, n=1, theta_min=[0.0], theta_max=[4.0])
    t1 = dt.Flow(to_torch(chain1), dt.MetaData(**meta1), device="cpu")
    j1 = df.Flow(chain1, df.MetaData(**meta1))
    np.testing.assert_allclose(
        t1.log_prob(x[:, :3], 2.0).detach().numpy(),
        np.asarray(j1.log_prob(jnp.asarray(x[:, :3]), 2.0)), **TOL)
    assert float(t1.prepare_theta(2.0, (1,))[0, 0]) == 0.5


def test_non_float32_input_and_unported_arguments_raise(flows):
    _, tflow, _ = flows
    x, _ = inputs(D, N, 4, 0)
    with pytest.raises(TypeError, match="float32"):
        tflow.log_prob(x.astype(np.float64), (0.5, 1.0))
    with pytest.raises(TypeError, match="float32"):
        tflow.forward(torch.as_tensor(x).half(), (0.5, 1.0))
    # mesh= is ported (A9): an argument that is not a Mesh raises by name
    for call in (lambda: tflow.log_prob(x, (0.5, 1.0), mesh=object()),
                 lambda: tflow.sample((4,), (0.5, 1.0), mesh=object()),
                 lambda: tflow.sample_sweep(_raw_theta(2), 2, mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()
    with pytest.raises(TypeError):
        dt.Flow(tflow.model, "not metadata", device="cpu")


def test_nll_loss_matches_jax(flows):
    jflow, tflow, _ = flows
    x, theta = inputs(D, N, 20, 3)
    want = float(df.nll_loss(jflow.model, jflow.base, jnp.asarray(x),
                             jnp.asarray(theta)))
    got = TFLOW.nll_loss(tflow.model, tflow.base, t(x), t(theta))
    assert got.requires_grad
    np.testing.assert_allclose(float(got.detach()), want, **TOL)


def test_flow_saved_by_the_port_loads_in_jax(flows, tmp_path):
    jflow, tflow, _ = flows
    path = str(tmp_path / "torch_flow")
    dt.save_flow(path, tflow)
    back = df.load_flow(path)
    x, _ = inputs(D, N, 11, 4)
    theta = _raw_theta(11)
    np.testing.assert_allclose(
        np.asarray(back.log_prob(jnp.asarray(x), jnp.asarray(theta))),
        np.asarray(jflow.log_prob(jnp.asarray(x), jnp.asarray(theta))),
        rtol=1e-6, atol=1e-6)
    assert back.train_loss == [3.0, 2.5] and back.valid_loss == [3.1]
    # and round-trips through the port's own loader bit for bit
    again = dt.load_flow(path, device="cpu")
    for a, b in zip(again.model.state_dict().values(),
                    tflow.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(FileExistsError):
        dt.save_flow(path, tflow)
    dt.save_flow(path, tflow, erase=True)
