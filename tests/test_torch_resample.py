"""The port's distributed resampler (``parallel/resample.py``) against the
JAX package's ``inference.systematic_resample`` on the CPU, and the
particle entry points' ``mesh=`` surface.

Two gloo ranks in two processes (a FILE rendezvous, a time limit per
process) run the ring resampler on their blocks; the joined blocks are held
against JAX's ancestor indices applied to the whole particle matrix, for the
same u₀. A rank's CDF slice is (its offset + its cumsum) / the sum of the
ranks' sums, so a grid point a few ulp from a CDF knot can take the
neighbouring ancestor: at most 2 rows may differ, each only where its grid
point lies within 1e-6 of a float64 knot between the two ancestors. On one
rank the ring resampler does the port's single-device arithmetic, and the
rows are equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import densityflows_tpu_torch as dt
from densityflows_tpu import inference as jinf
from densityflows_tpu_torch import inference as tinf
from densityflows_tpu_torch.parallel import resample as R

import _torch_cpu  # noqa: F401
import _torch_resample_worker as W

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
KNOT_TOL = 1e-6


def _jax_rows(lw, particles, u0_key):
    idx = np.asarray(jinf.systematic_resample(jnp.asarray(lw), u0_key))
    return particles[idx], idx


def _assert_same_rows(got, want, lw, u0, want_idx, particles):
    """Equal rows but for at most 2, each explained by a CDF knot."""
    n = lw.shape[0]
    diff = np.flatnonzero(~(got == want).all(axis=1))
    assert len(diff) <= 2, diff
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(w) / w.sum()
    for j in diff:
        u = (np.float32(u0) + np.float32(j)) / np.float32(n)
        # the ancestor the port took: the particle row it copied
        took = np.flatnonzero((particles == got[j]).all(axis=1))
        a, b = sorted((int(took[0]), int(want_idx[j])))
        assert np.min(np.abs(cdf[a:b] - u)) < KNOT_TOL, (j, a, b)


def _run_ranks(tmp_path, cases, world=2, timeout=180):
    init = tmp_path / "rendezvous"
    spec = tmp_path / "cases.json"
    spec.write_text(json.dumps(cases))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, _TESTS, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_TESTS, "_torch_resample_worker.py"),
         str(r), str(world), str(init), str(tmp_path), str(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_REPO) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append(out[-2000:] + err[-4000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[1][-4000:] for p in procs]
        pytest.fail("a rank did not finish in time:\n" + "\n---\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [np.load(tmp_path / f"resample_{r}.npz") for r in range(world)]


def test_two_ranks_equal_jax_systematic_resample(tmp_path):
    """Random weights (n = 1000 and 1024), all the mass on one row of the
    last block, nearly all in the first block; u₀ from JAX's key, and u₀
    drawn by rank 0 from its generator and broadcast (each rank seeds its
    generator differently, so only the broadcast can make them agree)."""
    keys = {f"{name}_{n}_{s}": (name, n, jax.random.key(s))
            for name, n in (("random", 1000), ("random", 1024),
                            ("degenerate", 600), ("first_block", 800))
            for s in (0, 1)}
    cases = [dict(label=label, name=name, n=n,
                  u0=float(jax.random.uniform(key, ())))
             for label, (name, n, key) in keys.items()]
    cases.append(dict(label="broadcast", name="random", n=1000, seed=7))
    # u₀ = 0: the first grid point sits at the CDF's lower end, which only
    # the first block takes
    cases.append(dict(label="u0_zero", name="random", n=1000, u0=0.0))
    ranks = _run_ranks(tmp_path, cases)
    for case in cases:
        got = np.concatenate([r[case["label"]] for r in ranks])
        lw, particles = W.case_arrays(case["name"], case["n"])
        if case["label"] in ("broadcast", "u0_zero"):
            u0 = (torch.rand((), generator=torch.Generator().manual_seed(7))
                  if case["label"] == "broadcast" else torch.tensor(0.0))
            idx = tinf._systematic_resample(torch.as_tensor(lw), u0).numpy()
            want = particles[idx]
            u0 = float(u0)
        else:
            name, n, key = keys[case["label"]]
            want, idx = _jax_rows(lw, particles, key)
            u0 = case["u0"]
        assert got.shape == particles.shape
        _assert_same_rows(got, want, lw, u0, idx, particles)
        if case["name"] == "degenerate":
            np.testing.assert_array_equal(
                got, np.broadcast_to(particles[case["n"] - case["n"] // 4],
                                     got.shape))


@pytest.fixture
def gloo_one_rank(tmp_path):
    dt.distributed_init(f"file://{tmp_path}/pg", 1, 0, backend="gloo")
    yield dt.make_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["random", "degenerate", "first_block"])
def test_one_rank_mesh_equals_systematic_resample(case, gloo_one_rank,
                                                  monkeypatch):
    """A one-rank gloo group and the trivial mesh: the rows of
    ``systematic_resample`` for the same u₀, bit for bit, no point-to-point
    message; and JAX's rows but for knots."""
    def no_p2p(*args, **kwargs):
        raise AssertionError("a one-rank mesh sent a point-to-point message")

    monkeypatch.setattr(dist, "batch_isend_irecv", no_p2p)
    lw, particles = W.case_arrays(case, 1000)
    key = jax.random.key(3)
    u0 = jax.random.uniform(key, ())
    assert gloo_one_rank.group is not None
    for u in (float(u0), 0.0):
        want = particles[tinf._systematic_resample(
            torch.as_tensor(lw), torch.tensor(u)).numpy()]
        for mesh in (gloo_one_rank, dt.Mesh()):
            got = dt.systematic_resample_sharded(
                torch.as_tensor(lw), torch.as_tensor(particles), None, mesh,
                u0=u).numpy()
            np.testing.assert_array_equal(got, want)
    got = dt.systematic_resample_sharded(
        torch.as_tensor(lw), torch.as_tensor(particles), None, dt.Mesh(),
        u0=float(u0)).numpy()
    jwant, jidx = _jax_rows(lw, particles, key)
    _assert_same_rows(got, jwant, lw, float(u0), jidx, particles)
    with pytest.raises(ValueError, match="data"):
        dt.systematic_resample_sharded(torch.as_tensor(lw),
                                       torch.as_tensor(particles), None,
                                       dt.Mesh(), axis="model")


def test_generator_draws_u0_on_one_rank():
    lw, particles = W.case_arrays("random", 512)
    got = R.systematic_resample_sharded(
        torch.as_tensor(lw), torch.as_tensor(particles),
        torch.Generator().manual_seed(4), dt.Mesh())
    u0 = torch.rand((), generator=torch.Generator().manual_seed(4))
    idx = tinf._systematic_resample(torch.as_tensor(lw), u0)
    np.testing.assert_array_equal(got.numpy(), particles[idx.numpy()])


def test_mesh_raises_on_the_particle_entry_points():
    """``mesh=`` splits a particle axis over the mesh's ``data`` axis (A9,
    ported): on the trivial one-process mesh the four particle entry points
    give the calls without a mesh, from the same generator state; an
    argument that is not a ``Mesh`` raises ``TypeError`` by name."""
    def flow():
        chain = dt.flow_chain(dt.coupling_layer(
            2, [0], device="cpu", generator=torch.Generator().manual_seed(0),
            zero_init_final=False))
        return dt.Flow(chain, dt.MetaData("", 2, 0, np.zeros(0),
                                          np.zeros(0)), device="cpu")

    logp = lambda x: -(x * x).sum(-1)  # noqa: E731
    calls = (
        lambda f, **kw: dt.sample_with_rejection(
            f, 4, lambda x: x[..., 0] > 0, **kw),
        lambda f, **kw: dt.fit_variational(f, logp, steps=2, **kw) and
        torch.cat([p.detach().reshape(-1) for p in f.model.parameters()]),
        lambda f, **kw: dt.run_smc(logp, 2, 16, device="cpu", **kw)[0],
        lambda f, **kw: dt.flow_mcmc(f, logp, n_steps=4, burn_in=0,
                                     **kw)[0],
    )
    for call in calls:
        want = call(flow(), generator=torch.Generator().manual_seed(3))
        got = call(flow(), generator=torch.Generator().manual_seed(3),
                   mesh=dt.make_mesh())
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        with pytest.raises(TypeError, match="Mesh"):
            call(flow(), mesh=object())
