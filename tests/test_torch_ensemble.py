"""The deep ensemble of the PyTorch port (``densityflows_tpu_torch/ensemble.py``
and ``save_ensemble`` / ``load_ensemble``) against the JAX package's on the
CPU.

Each case of the JAX suite's ``tests/test_ensemble.py`` is ported under its
name. The JAX ensemble is trained first; the port's members are built from
its members' leaves (through ``convert.py``) and trained on its per-member
batch orders (``_epoch_perms``), and its mixture draws are replayed through
``_draws=``. Tolerances: histories and log-probabilities 1e-4 (a few epochs
of f32 Adam on both sides, the sums in another order), parameters 1e-3.
The member-sharded case runs two gloo ranks as subprocesses.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
from densityflows_tpu_torch import ensemble as TE
from densityflows_tpu_torch.inference import _Draws

from _torch_parity import jax_epoch_perms

HIST_ATOL, PARAM_ATOL, LP_ATOL = 1e-4, 1e-3, 1e-4
_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)


def _jax_factory_for(data):
    def factory(key):
        ks = jax.random.split(key, 2)
        return df.flow_chain(
            df.coupling_layer(data, [0, 1], key=ks[0]),
            df.coupling_layer(data, [1, 2], key=ks[1]),
        )
    return factory


def _data(seed=0, n=500):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * np.array([1.0, 0.5, 2.0])).astype(np.float32)
    th = rng.choice([-1.0, 2.0], size=(n, 1)).astype(np.float32)
    return (df.DataArrays.make(x, th, rng=0), dt.DataArrays.make(x, th, rng=0),
            x, th)


def _jax_members(factory, key, k):
    k_init, _ = jax.random.split(key)
    return [factory(kk) for kk in jax.random.split(k_init, k)]


def _jax_member_perms(key, k, epochs, n):
    """The batch orders of JAX's vmapped program: member m draws from
    ``split(k_train, K)[m]``, one permutation per ``split`` of that key."""
    _, k_train = jax.random.split(key)
    return np.stack([jax_epoch_perms(kk, epochs, n)
                     for kk in jax.random.split(k_train, k)])


def _port_factory(jax_members):
    """The port's factory: member i of the JAX ensemble, leaf for leaf."""
    it = iter(jax_members)

    def factory(generator):
        m = next(it)
        return dt.chain_from_spec_and_leaves(
            jax_spec(m), [np.asarray(l) for l in jax.tree_util.tree_leaves(m)],
            "cpu")
    return factory


def _both(seed, k, epochs, key, optimizer=None, **kw):
    """The JAX ensemble and the port's on the same members and orders."""
    jd, td, x, th = _data(seed)
    jfac = _jax_factory_for(jd)
    jopt = optax.adam(1e-3) if optimizer is None else optimizer[0]
    jens = df.train_ensemble(jfac, jd, n_members=k, epochs=epochs, key=key,
                             optimizer=jopt, verbose=False, **kw)
    perms = _jax_member_perms(key, k, epochs, len(jd.partition.training))
    tens = dt.train_ensemble(
        _port_factory(_jax_members(jfac, key, k)), td, n_members=k,
        epochs=epochs, generator=torch.Generator().manual_seed(0),
        optimizer=None if optimizer is None else optimizer[1],
        verbose=False, device="cpu", _epoch_perms=perms)
    return jens, tens, x, th


def _assert_ensembles_close(jens, tens, hist_atol=HIST_ATOL):
    np.testing.assert_allclose(np.asarray(tens.train_loss),
                               np.asarray(jens.train_loss), atol=hist_atol)
    np.testing.assert_allclose(np.asarray(tens.valid_loss),
                               np.asarray(jens.valid_loss), atol=hist_atol)
    jl = jax.tree_util.tree_leaves(jens.model)
    tl = tens.model.leaves()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape)
        if a.size:
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=PARAM_ATOL)


def test_train_ensemble_members_differ_and_converge():
    jens, ens, x, th = _both(0, 3, 6, jax.random.key(0))
    tls = np.asarray(ens.train_loss)       # (epochs, K)
    assert tls.shape == (6, 3)
    assert np.all(np.isfinite(tls))
    assert np.all(tls[-1] < tls[0])        # every member improves
    lp = ens.log_prob_members(x[:50], th[:50]).numpy()
    assert lp.shape == (3, 50)
    assert not np.allclose(lp[0], lp[1])
    _assert_ensembles_close(jens, ens)
    np.testing.assert_allclose(
        lp, np.asarray(jens.log_prob_members(x[:50], th[:50])), atol=LP_ATOL)
    assert ens.trained_path == ["torch"] * 3
    assert ens.fused_decline_reason == ["non-CUDA device (cpu)"] * 3


def test_ensemble_log_prob_is_mixture():
    jens, ens, x, th = _both(1, 3, 3, jax.random.key(1))
    lp_m = ens.log_prob_members(x[:20], th[:20]).numpy()
    lp = ens.log_prob(x[:20], th[:20]).numpy()
    want = np.log(np.mean(np.exp(lp_m.astype(np.float64)), axis=0))
    np.testing.assert_allclose(lp, want, rtol=1e-5)
    pr = ens.prob(x[:20], th[:20]).numpy()
    np.testing.assert_allclose(pr, np.exp(lp), rtol=1e-6)
    np.testing.assert_allclose(
        lp, np.asarray(jens.log_prob(x[:20], th[:20])), atol=LP_ATOL)


def test_ensemble_member_extraction_matches():
    jens, ens, x, th = _both(2, 2, 3, jax.random.key(2))
    m0 = ens.member(0)
    lp_member = m0.log_prob(x[:10], th[:10]).detach().numpy()
    lp_stacked = ens.log_prob_members(x[:10], th[:10]).numpy()[0]
    np.testing.assert_allclose(lp_member, lp_stacked, rtol=1e-5)
    assert len(m0.train_loss) == 3
    assert m0.train_loss == [row[0] for row in ens.train_loss]
    assert m0.trained_path == "torch"
    assert m0.fused_decline_reason == "non-CUDA device (cpu)"
    np.testing.assert_allclose(
        lp_member, np.asarray(jens.member(0).log_prob(x[:10], th[:10])),
        atol=LP_ATOL)


class _JaxMixtureDraws(_Draws):
    """The draws of JAX's ``EnsembleFlow.sample``: the (K, per, d) base
    draw from the first split of the key, the permutation from the
    second."""

    def __init__(self, jens, key, n):
        super().__init__(None, "cpu")
        k_draw, k_mix = jax.random.split(key)
        per = -(-n // jens.n_members)
        self._r = np.asarray(jens.base.sample(
            k_draw, (jens.n_members, per), jnp.float32))
        self._perm = np.asarray(jax.random.permutation(
            k_mix, jens.n_members * per))

    def base(self, base, shape):
        assert tuple(shape) == self._r.shape[:2]
        return torch.as_tensor(np.array(self._r))

    def permutation(self, n):
        assert n == self._perm.shape[0]
        return torch.as_tensor(np.array(self._perm))


def test_ensemble_sampling_shape_and_mixing():
    jens, ens, x, th = _both(3, 3, 2, jax.random.key(3))
    s = ens.sample((1000,), (-1.0,),
                   generator=torch.Generator().manual_seed(4))
    assert s.shape == (1000, 3)
    assert bool(torch.isfinite(s).all())
    s2 = ens.sample((10, 7), (-1.0,),
                    generator=torch.Generator().manual_seed(5))
    assert s2.shape == (10, 7, 3)
    # JAX's stratified recipe on JAX's draws: the same rows
    for dims, key in (((1000,), jax.random.key(4)), ((10, 7), jax.random.key(5))):
        want = np.asarray(jens.sample(dims, (-1.0,), key=key))
        got = ens.sample(dims, (-1.0,), _draws=_JaxMixtureDraws(
            jens, key, int(np.prod(dims)))).numpy()
        np.testing.assert_allclose(got, want, atol=LP_ATOL, rtol=1e-4)


def test_stack_models_rejects_mismatched_structures():
    _, td, x, _ = _data(4)
    g = torch.Generator().manual_seed(0)
    a = dt.coupling_layer(td, [0, 1], generator=g, device="cpu")
    b = dt.coupling_layer(td, [0], generator=g, device="cpu")  # another mask
    with pytest.raises(ValueError):
        dt.stack_models([dt.flow_chain(a), dt.flow_chain(b)])
    with pytest.raises(ValueError):
        dt.stack_models([])
    # an LU layer's pivots are static structure: built from two generators
    # they differ, built from one seed they stack
    lus = [dt.invertible_linear_layer(
        3, generator=torch.Generator().manual_seed(s), device="cpu")
        for s in (0, 5, 0)]
    assert lus[0].perm != lus[1].perm
    with pytest.raises(ValueError, match="one structure"):
        dt.stack_models([dt.flow_chain(lus[0]), dt.flow_chain(lus[1])])
    stacked = dt.stack_models([dt.flow_chain(lus[0]), dt.flow_chain(lus[2])])
    assert [tuple(l.shape) for l in stacked.leaves()] == [
        (2, 3, 3), (2, 3, 3), (2, 3)]


def test_ensemble_checkpoint_roundtrip(tmp_path):
    jens, ens, x, th = _both(5, 3, 2, jax.random.key(6))
    dt.save_ensemble(str(tmp_path / "ens"), ens)
    ens2 = dt.load_ensemble(str(tmp_path / "ens"), device="cpu")
    assert ens2.n_members == 3
    lp1 = ens.log_prob(x[:10], th[:10]).numpy()
    lp2 = ens2.log_prob(x[:10], th[:10]).numpy()
    np.testing.assert_array_equal(lp1, lp2)
    assert np.asarray(ens2.train_loss).shape == (2, 3)
    s = ens2.sample((100,), (-1.0,),
                    generator=torch.Generator().manual_seed(7))
    assert s.shape == (100, 3) and bool(torch.isfinite(s).all())
    # across packages, both ways: the same files
    j_from_port = df.load_ensemble(str(tmp_path / "ens"))
    np.testing.assert_allclose(
        np.asarray(j_from_port.log_prob(x[:10], th[:10])), lp1, atol=LP_ATOL)
    assert np.asarray(j_from_port.train_loss).tolist() == ens.train_loss
    df.save_ensemble(str(tmp_path / "jens"), jens)
    port_from_jax = dt.load_ensemble(str(tmp_path / "jens"), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(jens.model),
                    port_from_jax.model.leaves()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(
        port_from_jax.log_prob(x[:10], th[:10]).numpy(),
        np.asarray(jens.log_prob(x[:10], th[:10])), atol=LP_ATOL)
    # and through convert.py, in memory
    parts = dt.ensemble_to_jax_numpy(ens)
    back = dt.ensemble_from_jax_numpy(**parts, device="cpu")
    np.testing.assert_array_equal(back.log_prob(x[:10], th[:10]).numpy(),
                                  lp1)


def _worker_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, _TESTS, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(tmp_path, world=2, timeout=240):
    init = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_TESTS, "_torch_ensemble_worker.py"),
         str(r), str(world), str(init), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_worker_env(), cwd=_REPO) for r in range(world)]
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
    out = []
    for r in range(world):
        with open(tmp_path / f"result_{r}.json") as f:
            out.append(json.load(f))
    return out


def test_ensemble_member_axis_sharded_matches_unsharded(tmp_path):
    """mesh= shards the member axis over two gloo ranks (no collective while
    training, an all-gather at the end): the histories and parameters equal
    the one-process run with the same generator, on both ranks, and that
    run equals JAX's on the same members and orders; a count the mesh does
    not divide raises on every rank."""
    import _torch_ensemble_worker as W

    ranks = _run_ranks(tmp_path)
    assert ranks[0] == ranks[1]
    ref = W.single_process(None)
    np.testing.assert_allclose(ranks[0]["train_loss"], ref["train_loss"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["valid_loss"], ref["valid_loss"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["leaves"], ref["leaves"], rtol=0,
                               atol=1e-6)
    assert all(r["raised"] and "multiple of the mesh" in r["raised"]
               for r in ranks)
    assert ranks[0]["trained_path"] == ["torch"] * W.K
    assert ranks[0]["decline"] == ["non-CUDA device (cpu)"] * W.K
    with pytest.raises(ValueError, match="multiple of the mesh"):
        TE.train_ensemble(W.factory(W.build_data()[1]), W.build_data()[1],
                          n_members=3, epochs=1, verbose=False,
                          device="cpu", mesh=_Mesh2())


class _Mesh2(dt.Mesh):
    def __init__(self):
        super().__init__(None, 2, 0)


def test_member_launch_route_matches_jax():
    """The route a CUDA ensemble takes, one ``run_fused_train_members``
    call (on CPU tensors: the kernel's plain version per member), from the
    folded members to the unfolded histories and parameters: JAX's vmapped
    program at 1e-4 / 1e-3."""
    jd, td, x, th = _data(6)
    jfac = _jax_factory_for(jd)
    key, k, epochs = jax.random.key(8), 3, 3
    jens = df.train_ensemble(jfac, jd, n_members=k, epochs=epochs, key=key,
                             optimizer=optax.adam(1e-3), verbose=False)
    perms = _jax_member_perms(key, k, epochs, len(jd.partition.training))
    fac = _port_factory(_jax_members(jfac, key, k))
    flows = [dt.Flow(fac(None), td, device="cpu") for _ in range(k)]
    folds, packed = TE._kernel_members(flows, 64)
    xt, tht = td.normalized_training_data(flows[0].metadata)
    xv, thv = td.normalized_validation_data(flows[0].metadata)
    arrays = tuple(torch.as_tensor(a) for a in (xt, tht, xv, thv))
    tls, vls = TE._train_members_kernel(flows, folds, packed, arrays, perms,
                                        64, {})
    np.testing.assert_allclose(tls.T, np.asarray(jens.train_loss),
                               atol=HIST_ATOL)
    np.testing.assert_allclose(vls.T, np.asarray(jens.valid_loss),
                               atol=HIST_ATOL)
    got = TE.StackedModels([f.model for f in flows]).leaves()
    for a, b in zip(jax.tree_util.tree_leaves(jens.model), got):
        if a.size:
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=PARAM_ATOL)


def test_member_launch_envelope():
    """One launch shares the plan, masks and constants: members whose
    normalization ranges differ, and chains outside train_run's envelope,
    decline by name."""
    _, td, x, _ = _data(7)
    g = torch.Generator().manual_seed(0)

    def chain(x_ref, kind=dt.RNVPCouplingLayer):
        return dt.flow_chain(
            dt.coupling_layer(td, [0, 1], kind=kind, generator=g,
                              device="cpu"),
            dt.normalization_layer(x_ref, -1.0, 1.0, device="cpu"))

    same = [dt.Flow(chain(x), td, device="cpu") for _ in range(2)]
    folds, packed = TE._kernel_members(same, 64)
    assert len(folds) == 2 and packed.n_params > 0
    other = [dt.Flow(chain(x), td, device="cpu"),
             dt.Flow(chain(x * 2.0), td, device="cpu")]
    with pytest.raises(dt.UnsupportedFusedTrain, match="constants"):
        TE._kernel_members(other, 64)
    spline = [dt.Flow(chain(x, dt.RQSCouplingLayer), td, device="cpu")]
    with pytest.raises(dt.UnsupportedFusedTrain, match="RQSCouplingLayer"):
        TE._kernel_members(spline, 64)


def test_ensemble_with_another_optimizer_runs_the_plain_program():
    jens, ens, x, th = _both(
        8, 2, 2, jax.random.key(9),
        optimizer=(optax.sgd(1e-2), _Sgd(1e-2)))
    _assert_ensembles_close(jens, ens)
    assert ens.trained_path == ["torch", "torch"]


class _Sgd:
    """Plain gradient descent with the port's optimizer interface."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    def update(self, grads, state, params=None):
        return [-self.lr * g for g in grads], state


def _member_flows(td, x, scales, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [dt.Flow(dt.flow_chain(
        dt.coupling_layer(td, [0, 1], generator=g, device="cpu"),
        dt.coupling_layer(td, [1, 2], generator=g, device="cpu"),
        dt.normalization_layer(x * s, -1.0, 1.0, device="cpu")), td,
        device="cpu") for s in scales]


def test_vmapped_members_equal_the_per_member_program():
    """The plain route's one program over the member axis against the plain
    program member after member, on the same members and batch orders."""
    _, td, x, _ = _data(5)
    meta = td.metadata()
    arrays = tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in (
        *td.normalized_training_data(meta),
        *td.normalized_validation_data(meta)))
    n = arrays[0].shape[0]
    rng = np.random.default_rng(5)
    perms = np.stack([np.stack([rng.permutation(n) for _ in range(3)])
                      for _ in range(3)])
    one, each = (_member_flows(td, x, [1.0] * 3) for _ in range(2))
    assert TE._one_program(one)
    got = TE._train_members_vmapped(one, dt.Adam(), arrays, perms, 64, 3,
                                    True)
    want = TE._train_members_plain(each, dt.Adam(), arrays, perms, 64, 3,
                                   True)
    for a, b in zip(got, want):
        assert a.shape == (3, 3)
        np.testing.assert_allclose(a, b, atol=1e-5)
    for f, g in zip(one, each):
        for a, b in zip(f.model.parameters(), g.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), atol=PARAM_ATOL)


@pytest.mark.parametrize("case", ["per_layer_kernels", "constants_differ"])
def test_members_outside_one_program_train_one_after_another(case,
                                                            monkeypatch):
    """Members whose non-trainable leaves differ, or under the per-layer
    kernels (autograd functions without a batching rule), cannot share the
    vmapped program: ``train_ensemble`` trains them member after member."""
    _, td, x, _ = _data(6)
    scales = iter([1.0, 2.0] if case == "constants_differ" else [1.0, 1.0])
    factory = lambda g: _member_flows(  # noqa: E731
        td, x, [next(scales)], seed=int(torch.randint(99, (1,),
                                                      generator=g)))[0].model
    ran = []
    plain = TE._train_members_plain
    monkeypatch.setattr(TE, "_train_members_plain",
                        lambda *a: ran.append(len(a[0])) or plain(*a))
    if case == "per_layer_kernels":
        dt.set_fused_kernels(True)
    try:
        ens = dt.train_ensemble(factory, td, n_members=2, epochs=2,
                                generator=torch.Generator().manual_seed(1),
                                verbose=False, device="cpu")
    finally:
        dt.set_fused_kernels("auto")
    tls = np.asarray(ens.train_loss)
    assert tls.shape == (2, 2) and np.isfinite(tls).all()
    assert ens.trained_path == ["torch", "torch"] and ran == [2]
