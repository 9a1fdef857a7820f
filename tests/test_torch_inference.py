"""The port's inference engine (``densityflows_tpu_torch/inference.py``)
against the JAX package's (``densityflows_tpu/inference.py``) on the CPU.

Both sides get the same numpy weights and data. The two packages' random
streams differ (threefry against ``torch.Generator``), so no parity test
compares draws of the two: each rebuilds the JAX program's own draws from
its key splits and hands them to the port, in the JAX order, through the
private ``_draws`` hook (:class:`Fed`). Tests of the port alone (the
conjugate-Gaussian recoveries, moment recovery) draw from a
``torch.Generator``.

Tolerances: float32 on both sides, a few layers deep: 1e-5 on one loss,
1e-4 on gradients, on one Adam step and on per-step / per-epoch losses over
a few steps (``TRAIN_ATOL``), 1e-3 on parameters after a few epochs of Adam
(ROADMAP §C's drift rule), 1e-12 on the numpy diagnostics (the same float64
code). Resampling counts the rows where the two packages pick different
ancestors and allows them only where the grid point lies within 1e-6 of a
float64 CDF knot: the port's CDF is cumsum(exp(lw − max)) / last, JAX's
cumsum(exp(lw − logsumexp)) / last, each summed in its own order, so a grid
point a few ulp from a knot can fall on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu import inference as jinf
from densityflows_tpu.models.flow import nll_loss as jax_nll_loss
from densityflows_tpu_torch import inference as tinf
from densityflows_tpu_torch.models.fused_train import trainable_leaves

from _torch_parity import (
    TRAIN_ATOL, assert_leaves_close, jax_epoch_perms, randomize, t, to_torch)

# a grid point this close to a float64 CDF knot may pick either neighbour
KNOT_TOL = 1e-6


class Fed(tinf._Draws):
    """The JAX program's draws, handed to the port in the JAX order."""

    def __init__(self, arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def _next(self, shape):
        a = self.queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.as_tensor(np.array(a))

    def base(self, base, shape):
        return self._next(tuple(shape) + (base.d,))

    def normal(self, shape):
        return self._next(shape)

    def uniform(self, shape):
        return self._next(shape)

    def permutation(self, n):
        return self._next((n,)).long()

    def atoms(self, b, n_atoms):
        return self._next((b, n_atoms)).long()

    def done(self):
        return not self.queue


def flow_pair(d=2, n=0, seed=0, hidden=8, lo=None, hi=None):
    """The same randomized two-coupling flow in both packages (CPU).
    Condition bounds away from [0, 1], so θ normalization shows."""
    ks = jax.random.split(jax.random.key(seed), 2)
    h = dict(hidden_dim_s=hidden, hidden_dim_t=hidden)
    chain = randomize(df.flow_chain(
        df.coupling_layer(d, [0], n=n, key=ks[0], **h),
        df.coupling_layer(d, list(range(1, d)), n=n, key=ks[1], **h)),
        seed + 100)
    lo = np.linspace(-2.0, -1.0, n).astype(np.float32) if lo is None else lo
    hi = np.linspace(2.0, 3.0, n).astype(np.float32) if hi is None else hi
    jflow = df.Flow(chain, df.MetaData("", d, n, lo, hi))
    tflow = dt.Flow(to_torch(chain), dt.MetaData("", d, n, lo, hi),
                    device="cpu")
    return jflow, tflow


def gauss_logp(mu, sc):
    mu, sc = np.asarray(mu, np.float32), np.asarray(sc, np.float32)

    def jlogp(x):
        u = (x - jnp.asarray(mu)) / jnp.asarray(sc)
        return -0.5 * jnp.sum(u * u, axis=-1)

    def tlogp(x):
        u = (x - torch.as_tensor(mu)) / torch.as_tensor(sc)
        return -0.5 * (u * u).sum(-1)

    return jlogp, tlogp


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


# -- effective sample size, systematic resampling --------------------------------

def _lw_case(name):
    rng = np.random.default_rng(7)
    if name == "random":
        return rng.normal(size=1024).astype(np.float32) * 2.0
    if name == "odd_n":
        return rng.normal(size=1000).astype(np.float32) * 3.0 - 5.0
    if name == "degenerate":
        lw = np.full(300, -np.inf, np.float32)
        lw[137] = 0.0
        return lw
    if name == "one_nan":
        lw = rng.normal(size=257).astype(np.float32)
        lw[11] = np.nan
        return lw
    if name == "all_neg_inf":
        return np.full(64, -np.inf, np.float32)
    raise ValueError(name)


def knot_explained(lw, u, a, b):
    """Whether grid point ``u`` lies within KNOT_TOL of a float64 CDF knot
    between the ancestors ``a`` and ``b`` the two packages picked."""
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w) / w.sum()
    lo, hi = min(a, b), max(a, b)
    return bool(np.min(np.abs(cdf[lo:hi] - u)) < KNOT_TOL) if hi > lo \
        else True


@pytest.mark.parametrize("case", ["random", "odd_n", "degenerate", "one_nan",
                                  "all_neg_inf"])
def test_ess_and_systematic_resample_against_jax(case):
    lw = _lw_case(case)
    n = lw.shape[0]
    je = np.asarray(jinf.effective_sample_size(jnp.asarray(lw)))
    te = tinf.effective_sample_size(t(lw)).numpy()
    if np.isnan(je):
        assert np.isnan(te)
    else:
        close(te, je, 0.0, rtol=1e-5)
    for seed in range(3):
        key = jax.random.key(seed)
        ji = np.asarray(jinf.systematic_resample(jnp.asarray(lw), key))
        u0 = jax.random.uniform(key, ())
        ti = tinf._systematic_resample(t(lw), t(u0)).numpy()
        assert ti.shape == (n,) and ti.dtype == np.int64
        assert ti.min() >= 0 and ti.max() <= n - 1
        if not np.isfinite(lw).any() or np.isnan(lw).any():
            # a NaN or all -inf log-weight makes both CDFs NaN: every grid
            # point takes the same ancestor in both packages
            np.testing.assert_array_equal(ti, ji)
            continue
        grid = (np.float32(u0) + np.arange(n, dtype=np.float32)) / n
        diff = np.flatnonzero(ti != ji)
        # at most 2 of the rows, each at a knot (module docstring)
        assert len(diff) <= 2, (case, seed, diff)
        for j in diff:
            assert knot_explained(lw, float(grid[j]), ti[j], ji[j])
        if case == "degenerate":
            assert (ti == 137).all()


def test_systematic_resample_counts_match_weights():
    n = 1000
    lw = np.log(np.arange(1, n + 1, dtype=np.float32))
    idx = dt.systematic_resample(t(lw), torch.Generator().manual_seed(8))
    counts = np.bincount(idx.numpy(), minlength=n)
    w = np.arange(1, n + 1) / np.sum(np.arange(1, n + 1))
    assert np.all(np.abs(counts - n * w) <= 1.0 + 1e-6)


# -- weighted NLL and its train step ---------------------------------------------

def _weighted_case(seed=3):
    jflow, tflow = flow_pair(d=3, n=2, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(48, 3)).astype(np.float32)
    th = rng.uniform(size=(48, 2)).astype(np.float32)
    w = rng.uniform(0, 2, size=48).astype(np.float32)
    w[:8] = 0.0
    return jflow, tflow, x, th, w


def test_weighted_nll_loss_and_gradients_against_jax():
    jflow, tflow, x, th, w = _weighted_case()
    jl, jg = jax.value_and_grad(jinf.weighted_nll_loss)(
        jflow.model, jflow.base, x, th, w)
    leaves = trainable_leaves(tflow.model)
    tl = dt.weighted_nll_loss(tflow.model, tflow.base, t(x), t(th), t(w))
    tg = torch.autograd.grad(tl, leaves)
    close(tl.detach(), jl, 1e-5)
    jleaves = [a for a in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        close(b, a, 1e-4)
    # uniform weights give the plain NLL; all-zero weights hit the guard
    ones = np.ones(48, np.float32)
    close(dt.weighted_nll_loss(tflow.model, tflow.base, t(x), t(th),
                               t(ones)).detach(),
          jax_nll_loss(jflow.model, jflow.base, x, th), 1e-5)
    zero = dt.weighted_nll_loss(tflow.model, tflow.base, t(x), t(th),
                                torch.zeros(48))
    assert float(zero.detach()) == 0.0
    assert float(jinf.weighted_nll_loss(jflow.model, jflow.base, x, th,
                                        np.zeros(48, np.float32))) == 0.0


def test_weighted_train_step_against_jax():
    jflow, tflow, x, th, w = _weighted_case(seed=4)
    opt = optax.adam(1e-3)
    jstep = df.make_weighted_train_step(opt)
    jm, _, jl = jstep(jflow.model, opt.init(jflow.model), jflow.base, x, th, w)
    topt = dt.adam(1e-3)
    tstep = dt.make_weighted_train_step(topt)
    tm, state, tl = tstep(tflow.model, topt.init(trainable_leaves(
        tflow.model)), tflow.base, t(x), t(th), t(w))
    assert state.count == 1 and tm is tflow.model
    close(tl, jl, 1e-5)
    assert_leaves_close(jm, tm, 1e-4, "weighted step")


# -- APT ------------------------------------------------------------------------

def test_atom_indices_structure():
    b, m = 16, 6
    idx = tinf._atom_indices(torch.Generator().manual_seed(0), b, m)
    assert idx.shape == (b, m) and idx.dtype == torch.int64
    assert torch.equal(idx[:, 0], torch.arange(b))
    for i, row in enumerate(idx.tolist()):
        assert len(set(row)) == m          # without replacement
        assert i not in row[1:]            # the others exclude the row
        assert all(0 <= j < b for j in row)


def test_apt_loss_and_gradients_against_jax():
    jflow, tflow = flow_pair(d=2, n=2, seed=5)
    rng = np.random.default_rng(5)
    b, m = 12, 4
    th = rng.normal(size=(b, 2)).astype(np.float32)
    x = rng.uniform(size=(b, 2)).astype(np.float32)
    lp = rng.normal(size=b).astype(np.float32)
    atom = np.asarray(jinf._atom_indices(jax.random.key(1), b, m))
    jl, jg = jax.value_and_grad(jinf.apt_loss)(
        jflow.model, jflow.base, jnp.asarray(th), jnp.asarray(x),
        jnp.asarray(lp), jnp.asarray(atom))
    leaves = trainable_leaves(tflow.model)
    tl = dt.apt_loss(tflow.model, tflow.base, t(th), t(x), t(lp),
                     torch.as_tensor(atom).long())
    tg = torch.autograd.grad(tl, leaves)
    close(tl.detach(), jl, 1e-5)
    for a, g in zip(jax.tree_util.tree_leaves(jg), tg):
        close(g, a, 1e-4)


def jax_apt_draws(key, epochs, n, batchsize, n_atoms):
    out = []
    n_batches = n // batchsize
    for ekey in jax.random.split(key, epochs):
        k_perm, k_atoms = jax.random.split(ekey)
        out.append(np.asarray(jax.random.permutation(k_perm, n)))
        for k in jax.random.split(k_atoms, n_batches):
            out.append(np.asarray(jinf._atom_indices(k, batchsize, n_atoms)))
    return out


def _posterior_sims(n, seed, d=2):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(n, d)).astype(np.float32)
    x = (theta + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    return theta, x


def _prior_log_prob(th):
    th = np.asarray(th, np.float64)
    return -0.5 * (th * th).sum(-1) - 0.5 * th.shape[-1] * np.log(2 * np.pi)


def test_fit_posterior_apt_against_jax():
    """2 epochs with JAX's permutations and atoms: per-epoch losses at 1e-4,
    parameters at 1e-3, on a flow whose condition bounds are not [0, 1] (x
    is normalized through the flow's θ-metadata on both sides)."""
    jflow, tflow = flow_pair(d=2, n=2, seed=6)
    theta, x = _posterior_sims(200, 6)
    key = jax.random.key(9)
    jinf.fit_posterior_apt(jflow, theta, x, _prior_log_prob, n_atoms=5,
                           epochs=2, batchsize=32, key=key)
    fed = Fed(jax_apt_draws(key, 2, 200, 32, 5))
    state = dt.fit_posterior_apt(tflow, theta, x, _prior_log_prob,
                                 n_atoms=5, epochs=2, batchsize=32,
                                 _draws=fed)
    assert fed.done() and state.count == 2 * (200 // 32)
    assert len(tflow.train_loss) == 2
    close(tflow.train_loss, jflow.train_loss, TRAIN_ATOL)
    assert_leaves_close(jflow.model, tflow.model, 1e-3, "apt")


def test_fit_posterior_apt_validates_its_arguments():
    _, tflow = flow_pair(d=2, n=2)
    theta, x = _posterior_sims(40, 1)
    with pytest.raises(ValueError, match="same number of rows"):
        dt.fit_posterior_apt(tflow, theta, x[:-1])
    with pytest.raises(ValueError, match="n_atoms"):
        dt.fit_posterior_apt(tflow, theta, x, n_atoms=1, batchsize=8)
    with pytest.raises(ValueError, match="full batch"):
        dt.fit_posterior_apt(tflow, theta, x, batchsize=64)
    bad = lambda th: np.where(th[:, 0] > 0, -np.inf, 0.0)  # noqa: E731
    with pytest.raises(ValueError, match="finite"):
        dt.fit_posterior_apt(tflow, theta, x, bad, n_atoms=4, batchsize=8)


# -- SNPE fits through train ------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_fit_posterior_against_jax(weighted):
    """The same batch order (JAX's permutations): 3 epochs' histories at
    1e-4, parameters at 1e-3."""
    jflow, tflow = flow_pair(d=2, n=2, seed=7)
    theta, x = _posterior_sims(150, 7)
    w = (np.random.default_rng(1).uniform(0.2, 2.0, size=150)
         .astype(np.float32) if weighted else None)
    key = jax.random.key(4)
    jinf.fit_posterior(jflow, theta, x, weights=w, epochs=3, key=key)
    n_train = len(dt.DataArrays.make(theta, x, rng=0).partition.training)
    dt.fit_posterior(tflow, theta, x, weights=w, epochs=3, generator=None,
                     _epoch_perms=jax_epoch_perms(key, 3, n_train))
    assert tflow.trained_path == "torch"
    close(tflow.train_loss, jflow.train_loss, TRAIN_ATOL)
    close(tflow.valid_loss, jflow.valid_loss, TRAIN_ATOL)
    assert_leaves_close(jflow.model, tflow.model, 1e-3, "fit_posterior")


# -- VI -----------------------------------------------------------------------------

def test_fit_variational_against_jax():
    """8 steps on JAX's base draws: per-step losses at 1e-4."""
    jflow, tflow = flow_pair(d=2, n=1, seed=8)
    jlogp, tlogp = gauss_logp([1.0, -0.5], [0.7, 0.7])
    key = jax.random.key(6)
    steps, n_p = 8, 64
    jinf.fit_variational(jflow, jlogp, theta=(0.3,), steps=steps,
                         n_particles=n_p, key=key)
    fed = Fed([np.asarray(jax.random.normal(k, (n_p, 2)))
               for k in jax.random.split(key, steps)])
    state = dt.fit_variational(tflow, tlogp, theta=(0.3,), steps=steps,
                               n_particles=n_p, _draws=fed)
    assert fed.done() and state.count == steps
    close(tflow.train_loss, jflow.train_loss, TRAIN_ATOL)
    assert_leaves_close(jflow.model, tflow.model, 1e-4, "vi")


# -- SMC ----------------------------------------------------------------------------

def jax_smc_step_draws(key, shape, n_mh):
    k_res, k_mh = jax.random.split(key)
    out = [np.asarray(jax.random.uniform(k_res, ()))]
    for k in jax.random.split(k_mh, n_mh):
        k1, k2 = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(k1, shape, jnp.float32)))
        out.append(np.asarray(jax.random.uniform(k2, shape[:1])))
    return out


@pytest.mark.parametrize("resample", [False, True])
def test_smc_step_against_jax(resample):
    """Both branches of the ESS test, on JAX's draws: the state, ESS and
    acceptance equal at 1e-5 (the same f32 arithmetic, row by row)."""
    rng = np.random.default_rng(11)
    n, d = 96, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    jlogp, tlogp = gauss_logp([1.0, 0.0, -1.0], [0.8, 1.2, 0.6])
    jprior, tprior = gauss_logp([0.0] * d, [1.0] * d)
    spread = 4.0 if resample else 0.1
    lw = (rng.normal(size=n) * spread).astype(np.float32)
    lam_old, lam_new = np.float32(0.25), np.float32(0.5)
    jstate = jinf.SMCState(jnp.asarray(x), jnp.asarray(lw),
                           jprior(jnp.asarray(x)), jlogp(jnp.asarray(x)))
    tstate = dt.SMCState(t(x), t(lw), tprior(t(x)), tlogp(t(x)))
    key = jax.random.key(12)
    js, jess, jacc = jinf.smc_step(jstate, jlogp, jprior, lam_old, lam_new,
                                   key, mh_step_size=0.3, n_mh=2)
    fed = Fed(jax_smc_step_draws(key, (n, d), 2))
    ts, tess, tacc = dt.smc_step(tstate, tlogp, tprior, t(lam_old),
                                 t(lam_new), mh_step_size=0.3, n_mh=2,
                                 _draws=fed)
    assert fed.done()
    assert (float(tess) < 0.5 * n) == resample
    close(tess, jess, 0.0, rtol=1e-5)
    close(tacc, jacc, 1e-6)
    for a, b in zip((ts.particles, ts.log_weights, ts.log_prior,
                     ts.log_target),
                    (js.particles, js.log_weights, js.log_prior,
                     js.log_target)):
        close(a, b, 1e-5, rtol=1e-5)
    if resample:
        assert float(ts.log_weights.abs().max()) == 0.0


def test_run_smc_recovers_gaussian_moments():
    mu = np.array([2.0, -1.0], np.float32)

    def log_p(x):
        return -0.5 * ((x - torch.as_tensor(mu)) ** 2).sum(-1)

    particles, log_w, diag = dt.run_smc(
        log_p, d=2, n_particles=2048, n_steps=10, init_scale=3.0,
        generator=torch.Generator().manual_seed(9), mh_step_size=0.5, n_mh=3,
        device="cpu")
    assert particles.shape == (2048, 2) and log_w.shape == (2048,)
    w = torch.softmax(log_w.double(), 0)
    est = (particles.double() * w[:, None]).sum(0).numpy()
    np.testing.assert_allclose(est, mu, atol=0.25)
    assert diag["ess"].shape == (10,) and bool((diag["ess"] > 0).all())
    assert diag["mh_accept"].shape == (10,)


# -- flow MCMC ------------------------------------------------------------------------

def jax_mcmc_draws(key, n_chains, d, n_steps):
    """The draws of JAX flow_mcmc with a standard-normal base: z0, then per
    step a normal (the proposal's base draw or the random-walk step) and a
    uniform."""
    k_init, k_run = jax.random.split(key)
    out = [np.asarray(jax.random.normal(k_init, (n_chains, d)))]
    for k in jax.random.split(k_run, n_steps):
        k1, k2 = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(k1, (n_chains, d))))
        out.append(np.asarray(jax.random.uniform(k2, (n_chains,))))
    return out


@pytest.mark.parametrize("method", ["independence", "neutra"])
def test_flow_mcmc_against_jax(method):
    """5 steps on JAX's draws, conditional flow with θ: the same accept
    decisions (64 chains × 5 steps; a flip needs |log u − log α| within
    float rounding) and draws at 1e-5."""
    jflow, tflow = flow_pair(d=2, n=1, seed=10)
    jlogp, tlogp = gauss_logp([0.5, -0.5], [0.9, 1.1])
    key = jax.random.key(13)
    kw = dict(theta=(0.4,), n_chains=64, n_steps=5, burn_in=1, method=method,
              step_size=0.6)
    js, jd = jinf.flow_mcmc(jflow, jlogp, key=key, **kw)
    fed = Fed(jax_mcmc_draws(key, 64, 2, 5))
    ts, td = dt.flow_mcmc(tflow, tlogp, _draws=fed, **kw)
    assert fed.done()
    assert ts.shape == (4, 64, 2) and td["burn_in"] == 1
    close(td["accept_rate"], jd["accept_rate"], 0.0)
    close(ts, js, 1e-5, rtol=1e-5)
    for name in ("r_hat", "ess"):
        close(td[name], jd[name], 1e-6, rtol=1e-4)


def _identity_flow(d=2, n=0):
    """Zero-initialized final layers: the model is the identity."""
    chain = dt.flow_chain(
        dt.coupling_layer(d, list(range(d // 2)), n=n, device="cpu",
                          generator=torch.Generator().manual_seed(0)),
        dt.coupling_layer(d, list(range(d // 2, d)), n=n, device="cpu",
                          generator=torch.Generator().manual_seed(1)))
    md = dt.MetaData("", d, n, np.zeros(n, np.float32),
                     np.ones(n, np.float32))
    return dt.Flow(chain, md, device="cpu")


@pytest.mark.parametrize("method", ["independence", "neutra"])
def test_flow_mcmc_recovers_target_moments(method):
    flow = _identity_flow()
    _, tlogp = gauss_logp([1.0, -0.5], [0.5, 0.8])
    samples, diag = dt.flow_mcmc(
        flow, tlogp, n_chains=512, n_steps=600, burn_in=200, method=method,
        step_size=0.8, generator=torch.Generator().manual_seed(2))
    assert samples.shape == (400, 512, 2)
    acc = diag["accept_rate"].numpy()
    assert acc.shape == (600,) and 0.01 < acc.mean() < 1.0
    s = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), [1.0, -0.5], atol=0.05)
    np.testing.assert_allclose(s.std(0), [0.5, 0.8], atol=0.05)
    assert np.all(diag["r_hat"] < 1.05)


def test_flow_mcmc_validates_args():
    flow = _identity_flow()
    _, tlogp = gauss_logp([0.0, 0.0], [1.0, 1.0])
    with pytest.raises(ValueError, match="method"):
        dt.flow_mcmc(flow, tlogp, method="hamiltonian")
    with pytest.raises(ValueError, match="burn_in"):
        dt.flow_mcmc(flow, tlogp, n_steps=10, burn_in=10)
    with pytest.raises(ValueError, match="burn_in"):
        dt.flow_mcmc(flow, tlogp, n_steps=10, burn_in=-1)
    # fewer than 4 kept steps: no convergence diagnostics
    _, diag = dt.flow_mcmc(flow, tlogp, n_chains=8, n_steps=5, burn_in=2,
                           generator=torch.Generator().manual_seed(0))
    assert "r_hat" not in diag and diag["accept_rate"].shape == (5,)


# -- diagnostics ------------------------------------------------------------------------

def test_mcmc_diagnostics_and_sbc_uniformity_against_jax():
    rng = np.random.default_rng(0)
    n, m, d = 201, 8, 3
    offsets = rng.normal(scale=5.0, size=(1, m, d))
    cases = [offsets + 0.1 * rng.normal(size=(n, m, d)),
             rng.normal(size=(n, m, d)),
             np.cumsum(rng.normal(size=(n, m, d)), axis=0),
             np.ones((50, 4, d))]
    for s in cases:
        jd, td = jinf.mcmc_diagnostics(s), dt.mcmc_diagnostics(s)
        for name in ("r_hat", "ess"):
            close(td[name], jd[name], 1e-12, rtol=1e-12)
    assert dt.mcmc_diagnostics(torch.as_tensor(cases[1]))["ess"].shape == (d,)
    for bad in (np.zeros((10, 4)), np.zeros((3, 4, 2))):
        with pytest.raises(ValueError):
            dt.mcmc_diagnostics(bad)
    ranks = rng.integers(0, 101, size=(300, 4))
    assert dt.sbc_uniformity(ranks, 100) == pytest.approx(
        jinf.sbc_uniformity(ranks, 100), abs=1e-12)


def test_sbc_uniform_when_posterior_exact_and_flags_a_narrow_one():
    flow = _identity_flow(d=2, n=3)
    rng = np.random.default_rng(0)
    n_sims, n_draws = 400, 127
    theta_true = rng.normal(size=(n_sims, 2)).astype(np.float32)
    x_obs = rng.uniform(size=(n_sims, 3)).astype(np.float32)
    ranks = dt.sbc_ranks(flow, theta_true, x_obs, n_draws=n_draws,
                         generator=torch.Generator().manual_seed(3))
    assert ranks.shape == (n_sims, 2) and ranks.dtype == torch.int64
    assert int(ranks.min()) >= 0 and int(ranks.max()) <= n_draws
    assert dt.sbc_uniformity(ranks, n_draws) < 1.63 / np.sqrt(n_sims)

    narrow = dt.Flow(flow.model, flow.metadata,
                     dt.DiagNormal(np.zeros(2, np.float32),
                                   0.2 * np.ones(2, np.float32)),
                     device="cpu")
    ranks = dt.sbc_ranks(narrow, theta_true, x_obs, n_draws=100,
                         generator=torch.Generator().manual_seed(4))
    assert dt.sbc_uniformity(ranks, 100) > 0.15
    assert float(((ranks == 0) | (ranks == 100)).double().mean()) > 0.3


# -- rejection sampling ---------------------------------------------------------------

def test_rejection_sampling_satisfies_condition():
    _, flow = flow_pair(d=2, n=0, seed=14)
    s = dt.sample_with_rejection(flow, 500, lambda x: x[..., 0] > 0.0,
                                 generator=torch.Generator().manual_seed(1),
                                 batch=2048)
    assert s.shape == (500, 2) and bool((s[:, 0] > 0).all())


def test_rejection_sampling_cap_raises():
    _, flow = flow_pair(d=2, n=0, seed=14)
    with pytest.raises(RuntimeError, match="accepted only 0/10 draws after "
                                           "3 rounds of 64"):
        dt.sample_with_rejection(flow, 10, lambda x: x[..., 0] > 1e9,
                                 generator=torch.Generator().manual_seed(2),
                                 batch=64, max_rounds=3)


@pytest.mark.parametrize("n_samples", [40, 150])
def test_rejection_sampling_same_rows_as_jax(n_samples):
    """JAX's candidate draws: the first ``n_samples`` accepted rows in draw
    order, rows past them dropped (40 fill in the first round, where more
    are accepted; 150 take several rounds, the last one overfull)."""
    jflow, tflow = flow_pair(d=2, n=1, seed=15)
    key, batch = jax.random.key(3), 64
    cond_j = lambda x: x[..., 0] > 0.3  # noqa: E731
    js = np.asarray(jinf.sample_with_rejection(
        jflow, n_samples, cond_j, (0.5,), key=key, batch=batch))
    draws, k = [], key
    rounds = -(-n_samples // 8) + 8
    for _ in range(rounds):
        k, k_draw = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(k_draw, (batch, 2))))
    fed = Fed(draws)
    ts = dt.sample_with_rejection(tflow, n_samples, lambda x: x[..., 0] > 0.3,
                                  (0.5,), batch=batch, _draws=fed)
    used = rounds - len(fed.queue)
    assert used >= (2 if n_samples > batch else 1)
    close(ts, js, 1e-5, rtol=1e-5)


# -- multi-round SNPE -------------------------------------------------------------------

def test_mixture_proposal_density_removes_truncation_bias():
    """Prior-support rejection makes the true proposal q_flow + ε·prior;
    weights from that mixture are unbiased where the q_flow-only density is
    badly biased (a fake 'flow' N(0.9, 0.4), prior U(0, 1): about 41 % of
    the flow's draws leave the support)."""
    m, s = 0.9, 0.4

    class FakeFlow:
        def sample(self, dims, cond, *, generator):
            return m + s * torch.randn((dims[0], 1), generator=generator)

        def log_prob(self, theta, cond):
            t_ = np.asarray(theta)[:, 0]
            return -0.5 * ((t_ - m) / s) ** 2 - np.log(s * np.sqrt(2 * np.pi))

    def prior_sample(rng, n):
        return rng.uniform(0, 1, size=(n, 1))

    def prior_log_prob(th):
        t_ = np.asarray(th)[:, 0]
        return np.where((t_ >= 0) & (t_ <= 1), 0.0, -np.inf)

    flow = FakeFlow()
    theta, log_q = dt.propose_from_posterior(
        flow, [0.0], 50_000, prior_sample, prior_log_prob,
        np.random.default_rng(0), torch.Generator().manual_seed(0))
    t_ = theta[:, 0]
    assert ((t_ >= 0) & (t_ <= 1)).all()
    lp = prior_log_prob(theta)
    w = np.exp(lp - log_q)
    assert abs(np.sum(w * t_) / np.sum(w) - 0.5) < 0.02
    w_naive = np.exp(lp - flow.log_prob(theta, None))
    assert abs(np.sum(w_naive * t_) / np.sum(w_naive) - 0.5) > 0.08


SIGMA = 0.5


def _conjugate_problem(kind):
    sim_rng = np.random.default_rng(0)

    def simulator(theta):
        return theta + SIGMA * sim_rng.normal(size=theta.shape)

    def prior_sample(rng, n):
        return rng.normal(size=(n, 1))

    def prior_log_prob(theta):
        t_ = np.asarray(theta)[:, 0]
        return -0.5 * t_**2 - 0.5 * np.log(2 * np.pi)

    net = (dict(kind=dt.RQSCouplingLayer, n_bins=8, hidden_dim_t=32)
           if kind == "rqs" else dict(hidden_dim_s=16, hidden_dim_t=16))
    flow = dt.Flow(
        dt.flow_chain(dt.coupling_layer(
            1, [0], n=1, generator=torch.Generator().manual_seed(0),
            device="cpu", **net)),
        dt.MetaData("", 1, 1, np.array([-4.0], np.float32),
                    np.array([4.0], np.float32)), device="cpu")
    return flow, simulator, prior_sample, prior_log_prob


# per method: the flow, rounds, simulations per round, epochs. APT is the
# JAX suite's case (an RQS flow, 2 × 800 simulations, 50 epochs). SNPE-B at
# the JAX suite's 3 × 800 / 40 epochs on the RQS flow misses 0.12 on about
# one seed in five in BOTH packages (the posterior mean of 9 JAX keys:
# 0.874 ± 0.06, of 10 port seeds: 0.873 ± 0.07, against 0.8): its importance
# weights keep an ESS of 50–300. The port's case takes 3 × 2,000 simulations
# on an affine (RealNVP) flow, 16 epochs, where 6 seeds ended within 0.096.
ROUNDS = {"snpe_b": ("rnvp", 3, 2000, 16), "apt": ("rqs", 2, 800, 50)}


@pytest.mark.parametrize("method", ["snpe_b", "apt"])
def test_multiround_snpe_recovers_conjugate_posterior(method):
    """θ ~ N(0, 1), x | θ ~ N(θ, σ²), x_obs = 1: the posterior is
    N(x_obs/(1+σ²), σ²/(1+σ²)); mean and std of 20,000 draws within 0.12
    (the JAX suite's gate)."""
    x_obs = 1.0
    post_mean = x_obs / (1 + SIGMA**2)
    post_std = np.sqrt(SIGMA**2 / (1 + SIGMA**2))
    kind, rounds, sims, epochs = ROUNDS[method]
    flow, simulator, prior_sample, prior_log_prob = _conjugate_problem(kind)
    flow, history = dt.fit_posterior_rounds(
        flow, simulator, prior_sample, prior_log_prob, [x_obs],
        n_rounds=rounds, n_sims_per_round=sims, epochs=epochs, method=method,
        n_atoms=10, generator=torch.Generator().manual_seed(1),
        rng=np.random.default_rng(2))
    assert [h["n_sims"] for h in history] == [sims * (r + 1)
                                              for r in range(rounds)]
    if method == "apt":
        assert [h["weight_ess"] for h in history] == [None] * rounds
    else:
        assert all(np.isfinite(h["weight_ess"]) and h["weight_ess"] > 1
                   for h in history)
    draws = flow.sample((20_000,), (x_obs,),
                        generator=torch.Generator().manual_seed(3))[:, 0]
    assert abs(float(draws.mean()) - post_mean) < 0.12
    assert abs(float(draws.std()) - post_std) < 0.12


def test_multiround_snpe_validates():
    flow, _, prior_sample, prior_log_prob = _conjugate_problem("rnvp")
    with pytest.raises(ValueError, match="one row per"):
        dt.fit_posterior_rounds(
            flow, lambda th: th[: len(th) // 2], prior_sample,
            prior_log_prob, [0.0], n_rounds=1, n_sims_per_round=64, epochs=1)
    with pytest.raises(ValueError, match="method"):
        dt.fit_posterior_rounds(flow, lambda th: th, prior_sample,
                                prior_log_prob, [0.0], method="snpe_a")
