"""``mesh=`` on serving and on the inference engine's particle axis, on the
CPU: ``Flow.log_prob`` / ``sample`` / ``sample_sweep`` and
``sample_with_rejection`` / ``flow_mcmc`` / ``fit_variational`` /
``run_smc`` on two gloo ranks in two processes
(``_torch_mesh2d_worker.py``, modes ``serving`` and ``inference``) against
the same calls in one process, and the one-process port against the JAX
package (JAX's own mesh= tests: ``tests/test_sharding.py``
``test_flow_sample_and_log_prob_mesh_match_unsharded``).

Tolerances: serving 1e-6 (rtol and atol, JAX's test): each rank folds its
rows with the same f32 arithmetic, only the products' row blocking differs.
The inference entry points on JAX's draws as in ``test_torch_inference.py``:
draws 1e-5 (abs and rel), acceptance exact, the variational losses 1e-4
(its ``TRAIN_ATOL``) and parameters 1e-4; ``run_smc`` on the port's own
generator 1e-5 (the ring resampler's CDF is summed per rank, then offset).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu import inference as jinf
from densityflows_tpu_torch.ops import chain_kernels as CK
from densityflows_tpu_torch.parallel import mesh as M

from _torch_mesh2d_worker import Fed, gauss_logp, run_ranks
from _torch_parity import randomize, to_torch

SERVE = dict(rtol=1e-6, atol=1e-6)
DRAWS = dict(rtol=1e-5, atol=1e-5)


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **tol)


@pytest.mark.parametrize("n,size", [(2**10 + 3, 4), (103, 3), (5, 4)])
def test_ceil_split_row_offset_draws_join_to_the_one_call_draw(n, size):
    """The shares of the ceil split, each drawn by the in-kernel generator's
    numpy model with ``row_offset = lo``, concatenate to the one-call draw
    bit for bit; on the CPU ``run_chain_sample``'s plain version with
    ``row_offset`` / ``total_rows`` folds exactly those rows of its one-call
    draw."""
    seed, d = 0x1234_5678_9ABC_DEF0, 7
    spans = [M._ceil_split(n, size, r) for r in range(size)]
    assert spans[0].start == 0 and spans[-1].stop == n
    parts = [CK.philox_normal_reference(seed, sl.stop - sl.start, d,
                                        sl.start) for sl in spans]
    whole = CK.philox_normal_reference(seed, n, d)
    assert np.concatenate(parts).tobytes() == whole.tobytes()

    chain = dt.flow_chain(dt.coupling_layer(
        d, [0, 1, 2], n=1, generator=torch.Generator().manual_seed(1),
        hidden_dim_s=8, hidden_dim_t=8, device="cpu"))
    from densityflows_tpu_torch.models.fused_chain import _plan_params

    plan, params = _plan_params(chain, "fwd")
    th = torch.full((1, 1), 0.5)
    one, noise = CK.run_chain_sample(plan, params, n, d, th, seed=7,
                                     return_noise=True)
    got = [CK.run_chain_sample(plan, params, sl.stop - sl.start, d, th,
                               seed=7, row_offset=sl.start, total_rows=n,
                               return_noise=True) for sl in spans]
    assert torch.equal(torch.cat([g[1] for g in got]), noise)
    torch.testing.assert_close(torch.cat([g[0] for g in got]), one,
                               **SERVE)


# -- serving -----------------------------------------------------------------

def serving_case():
    """JAX's mesh= test flow (d 4, n 2, one block of hidden 8 and a
    normalization layer) in both packages, and its inputs."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    th = rng.uniform(0, 1, size=(200, 2)).astype(np.float32)
    data = df.DataArrays.make(x, th, rng=0)
    jflow = df.Flow(df.flow_chain(
        df.coupling_block(data, None, key=jax.random.key(0), hidden_dim_s=8,
                          hidden_dim_t=8, zero_init_final=False),
        df.normalization_layer(x, -1.0, 1.0)), data)
    tflow = dt.Flow(to_torch(jflow.model), dt.DataArrays.make(x, th, rng=0),
                    device="cpu")
    thetas = rng.uniform(0.2, 0.8, size=(3, 2)).astype(np.float32)
    return jflow, tflow, x[:101], th[:101], thetas


def one_process_serving(tflow, x, th, thetas):
    """The worker's serving calls without a mesh."""
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    out = {}
    for route in ("auto", True):
        dt.set_fused_kernels(route)
        try:
            tag = "chain" if route is True else "plain"
            out[f"lp_{tag}"] = tflow.log_prob(x, th)
            out[f"sample_{tag}"] = tflow.sample((640,), (0.3, 0.7),
                                                generator=gen(1))
            out[f"sample_rows_{tag}"] = tflow.sample(
                (5, 7), th[:35].reshape(5, 7, 2), generator=gen(4))
            out[f"sweep_{tag}"] = tflow.sample_sweep(thetas, 16,
                                                     generator=gen(2))
        finally:
            dt.set_fused_kernels("auto")
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("serving"))
    jflow, tflow, x, th, thetas = serving_case()
    dt.save_flow(os.path.join(folder, "flow"), tflow)
    np.savez(os.path.join(folder, "serving.npz"), x=x, th=th, thetas=thetas)
    return (run_ranks("serving", folder),
            one_process_serving(tflow, x, th, thetas), jflow, x, th)


def test_log_prob_on_two_ranks_equals_one_process_and_jax(serving):
    """101 rows (odd: the ceil split pads the last share) on the per-layer
    path and on the chain route, and on a (2, 1) ("data", "model") mesh:
    every rank returns all rows, equal to one process at 1e-6; the
    one-process port equals JAX's ``log_prob(mesh=...)`` at 1e-5."""
    ranks, one, jflow, x, th = serving
    for r in ranks:
        for key in ("lp_plain", "lp_chain", "lp_2x1"):
            assert r[key].shape == (101,)
            close(r[key], one["lp_plain" if key == "lp_2x1" else key],
                  **SERVE)
    want = np.asarray(jflow.log_prob(jnp.asarray(x), th,
                                     mesh=jax.sharding.Mesh(
                                         np.array(jax.devices()), ("data",))))
    close(one["lp_plain"], want, rtol=1e-5, atol=1e-5)


def test_sample_and_sweep_on_two_ranks_equal_the_one_process_draw(serving):
    """The same generator state on both ranks: the sharded draws equal the
    one-process draw of that state (JAX: "same key, same draw stream →
    identical samples modulo placement") for a shared θ, per-row θ and a
    sweep, on the per-layer path and through ``chain_sample``'s plain
    version with its row offset."""
    ranks, one, _, _, _ = serving
    for r in ranks:
        for key in ("sample_plain", "sample_chain", "sample_rows_plain",
                    "sample_rows_chain", "sweep_plain", "sweep_chain"):
            assert r[key].shape == one[key].shape
            close(r[key], one[key], **SERVE)
    assert ranks[0]["sample_plain"].shape == (640, 4)
    assert ranks[0]["sweep_chain"].shape == (3, 16, 4)


def test_grid_form_with_a_mesh_raises(serving):
    ranks, _, _, _, _ = serving
    for r in ranks:
        assert "grid form" in str(r["grid"])
    _, tflow, _, _, _ = serving_case()
    with pytest.raises(ValueError, match="grid form"):
        tflow.log_prob((np.linspace(-1, 1, 4),) * 4, (0.3, 0.7),
                       mesh=dt.make_mesh())
    with pytest.raises(TypeError, match="Mesh"):
        tflow.sample((4,), (0.3, 0.7), mesh=object())


# -- the inference engine ----------------------------------------------------

def inference_flow(d, n, seed, hidden=8):
    """``test_torch_inference.flow_pair``'s flow in both packages."""
    ks = jax.random.split(jax.random.key(seed), 2)
    h = dict(hidden_dim_s=hidden, hidden_dim_t=hidden)
    chain = randomize(df.flow_chain(
        df.coupling_layer(d, [0], n=n, key=ks[0], **h),
        df.coupling_layer(d, list(range(1, d)), n=n, key=ks[1], **h)),
        seed + 100)
    lo = np.linspace(-2.0, -1.0, n).astype(np.float32)
    hi = np.linspace(2.0, 3.0, n).astype(np.float32)
    return (df.Flow(chain, df.MetaData("", d, n, lo, hi)),
            dt.Flow(to_torch(chain), dt.MetaData("", d, n, lo, hi),
                    device="cpu"))


def jax_gauss(mu, sc):
    mu, sc = jnp.asarray(mu, jnp.float32), jnp.asarray(sc, jnp.float32)
    return lambda x: -0.5 * jnp.sum(((x - mu) / sc) ** 2, axis=-1)


def jax_draws():
    """JAX's draws of each entry point (test_torch_inference.py's rules)."""
    out = {}
    k = jax.random.key(3)
    for i in range(27):
        k, k_draw = jax.random.split(k)
        out[f"rej{i}"] = np.asarray(jax.random.normal(k_draw, (64, 2)))
    for method in ("independence", "neutra"):
        key = jax.random.key(13)
        k_init, k_run = jax.random.split(key)
        arr = [np.asarray(jax.random.normal(k_init, (64, 2)))]
        for kk in jax.random.split(k_run, 5):
            k1, k2 = jax.random.split(kk)
            arr.append(np.asarray(jax.random.normal(k1, (64, 2))))
            arr.append(np.asarray(jax.random.uniform(k2, (64,))))
        out.update({f"mcmc_{method}{i}": a for i, a in enumerate(arr)})
    for i, kk in enumerate(jax.random.split(jax.random.key(6), 8)):
        out[f"vi{i}"] = np.asarray(jax.random.normal(kk, (64, 2)))
    return out


def one_process_inference(folder, draws):
    """The worker's inference calls without a mesh, the JAX package's on the
    same draws, and the flows the workers load."""
    def fed(prefix):
        keys = sorted((k for k in draws if k.startswith(prefix)),
                      key=lambda k: int(k[len(prefix):]))
        return Fed([draws[k] for k in keys])

    out, jax_out = {}, {}
    jflow, tflow = inference_flow(2, 1, 15)
    dt.save_flow(os.path.join(folder, "rej_flow"), tflow)
    out["rejection"] = dt.sample_with_rejection(
        tflow, 150, lambda v: v[..., 0] > 0.3, (0.5,), batch=64,
        _draws=fed("rej")).detach().numpy()
    jax_out["rejection"] = np.asarray(jinf.sample_with_rejection(
        jflow, 150, lambda v: v[..., 0] > 0.3, (0.5,),
        key=jax.random.key(3), batch=64))

    jflow, tflow = inference_flow(2, 1, 10)
    dt.save_flow(os.path.join(folder, "mcmc_flow"), tflow)
    logp = gauss_logp([0.5, -0.5], [0.9, 1.1])
    for method in ("independence", "neutra"):
        kw = dict(theta=(0.4,), n_chains=64, n_steps=5, burn_in=1,
                  method=method, step_size=0.6)
        s, diag = dt.flow_mcmc(tflow, logp, _draws=fed(f"mcmc_{method}"),
                               **kw)
        out[f"mcmc_{method}"] = s.numpy()
        out[f"mcmc_{method}_acc"] = diag["accept_rate"].numpy()
        out[f"mcmc_{method}_rhat"] = diag["r_hat"]
        js, jd = jinf.flow_mcmc(jflow, jax_gauss([0.5, -0.5], [0.9, 1.1]),
                                key=jax.random.key(13), **kw)
        jax_out[f"mcmc_{method}"] = np.asarray(js)
        jax_out[f"mcmc_{method}_acc"] = np.asarray(jd["accept_rate"])

    jflow, tflow = inference_flow(2, 1, 8)
    dt.save_flow(os.path.join(folder, "vi_flow"), tflow)
    dt.fit_variational(tflow, gauss_logp([1.0, -0.5], [0.7, 0.7]),
                       theta=(0.3,), steps=8, n_particles=64,
                       _draws=fed("vi"))
    jinf.fit_variational(jflow, jax_gauss([1.0, -0.5], [0.7, 0.7]),
                         theta=(0.3,), steps=8, n_particles=64,
                         key=jax.random.key(6))
    out["vi_loss"] = np.asarray(tflow.train_loss)
    jax_out["vi_loss"] = np.asarray(jflow.train_loss)
    out["vi_params"] = np.concatenate(
        [p.detach().reshape(-1).numpy() for p in tflow.model.parameters()
         if p.requires_grad])

    parts, log_w, diag = dt.run_smc(
        gauss_logp([2.0, -1.0], [1.0, 1.0]), 2, 256, n_steps=6,
        init_scale=3.0, generator=torch.Generator().manual_seed(9),
        mh_step_size=0.5, n_mh=2, device="cpu")
    out["smc_particles"], out["smc_log_w"] = parts.numpy(), log_w.numpy()
    out["smc_ess"], out["smc_acc"] = (diag["ess"].numpy(),
                                      diag["mh_accept"].numpy())
    return out, jax_out


@pytest.fixture(scope="module")
def inference(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("inference"))
    draws = jax_draws()
    np.savez(os.path.join(folder, "draws.npz"), **draws)
    one, jax_out = one_process_inference(folder, draws)
    return run_ranks("inference", folder), one, jax_out


def test_rejection_on_two_ranks_equals_one_process_and_jax(inference):
    """JAX's candidate draws, 150 rows over several rounds of 64: the
    accepted rows gathered in global row order equal one process's, which
    equal JAX's (1e-5)."""
    ranks, one, jax_out = inference
    for r in ranks:
        close(r["rejection"], one["rejection"], **DRAWS)
    close(one["rejection"], jax_out["rejection"], **DRAWS)


@pytest.mark.parametrize("method", ["independence", "neutra"])
def test_flow_mcmc_on_two_ranks_equals_one_process_and_jax(inference,
                                                           method):
    """64 chains split 32 / 32 on JAX's draws: the same accept decisions
    (the acceptance rates exactly), the kept draws at 1e-5, split-R̂ over all
    chains on both ranks."""
    ranks, one, jax_out = inference
    key = f"mcmc_{method}"
    for r in ranks:
        close(r[f"{key}_acc"], one[f"{key}_acc"], rtol=0, atol=1e-7)
        close(r[key], one[key], **DRAWS)
        close(r[f"{key}_rhat"], one[f"{key}_rhat"], rtol=1e-6, atol=1e-6)
    close(one[f"{key}_acc"], jax_out[f"{key}_acc"], rtol=0, atol=0)
    close(one[key], jax_out[key], **DRAWS)


def test_fit_variational_on_two_ranks_equals_one_process_and_jax(inference):
    """8 steps on JAX's draws, the particles split 32 / 32, the gradients of
    the global mean summed over the ranks: losses at 1e-4 against one
    process and JAX, parameters at 1e-4; both ranks hold the same
    parameters."""
    ranks, one, jax_out = inference
    np.testing.assert_array_equal(ranks[0]["vi_params"],
                                  ranks[1]["vi_params"])
    for r in ranks:
        assert int(r["vi_count"]) == 8
        close(r["vi_loss"], one["vi_loss"], rtol=0, atol=1e-4)
        close(r["vi_params"], one["vi_params"], rtol=0, atol=1e-4)
    close(one["vi_loss"], jax_out["vi_loss"], rtol=0, atol=1e-4)


def test_run_smc_on_two_ranks_equals_one_process(inference):
    """256 particles split 128 / 128, 6 tempering steps from one generator
    state: ESS and acceptance from all-reduces, resampling by the ring
    resampler, the particles and weights gathered on both ranks: equal to
    one process at 1e-5."""
    ranks, one, _ = inference
    for r in ranks:
        for key in ("smc_particles", "smc_log_w", "smc_ess", "smc_acc"):
            close(r[key], one[key], **DRAWS)
    assert float(one["smc_ess"].min()) < 128  # a resampling step ran
    with pytest.raises(ValueError, match="multiple of the data axis"):
        dt.run_smc(lambda x: -(x * x).sum(-1), 2, 255,
                   mesh=M.Mesh(None, 2, 0), device="cpu")
