"""The port's training (``densityflows_tpu_torch/train.py``) against the JAX
package on the CPU: the Adam step against ``optax.adam``, the masked NLL and
its gradients, the plain multi-epoch program's trajectories, routing and
declines, the chunked loops, and optimizer state across the two packages.

Both sides get the same numpy data, the same weights and the JAX package's
own batch order (its per-epoch permutations, injected through
``_epoch_perms``). Tolerances: ``TRAIN_ATOL`` = 1e-4 absolute, the JAX
suite's own bar for a few epochs on two paths (float accumulation order fed
through Adam); tighter where one step is compared.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.train import batch_iterator as jax_batch_iterator
from densityflows_tpu.train import masked_nll_loss as jax_masked_nll
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.utils.checkpoint import element_leaves

from _torch_parity import (
    TRAIN_ATOL, assert_leaves_close, assert_opt_state_close, cond_data,
    jax_epoch_perms, randomize, t, to_torch, torch_flow)


def reference_chain(jd, x, seed=0):
    ks = jax.random.split(jax.random.key(seed), 3)
    h = dict(hidden_dim_s=16, hidden_dim_t=16)
    return df.flow_chain(
        df.coupling_layer(jd, [0, 1, 2], key=ks[0], **h),
        df.coupling_layer(jd, [2, 3, 4], key=ks[1], **h),
        df.coupling_layer(jd, [4, 0, 1], key=ks[2], **h),
        df.normalization_layer(x, -1.0, 1.0))


def small_chain(jd, x):
    return df.flow_chain(
        df.coupling_layer(jd, [0, 1, 2], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0))


@pytest.fixture(scope="module")
def cond():
    return cond_data()


# -- (a) one Adam step against optax.adam -----------------------------------

@pytest.mark.parametrize("hp", [dict(learning_rate=1e-3),
                                dict(learning_rate=3e-3, b1=0.85),
                                dict(learning_rate=1e-2, b2=0.99, eps=1e-6)])
def test_adam_steps_equal_optax(hp):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (0,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.adam(**hp)
    jstate = tx.init([jnp.asarray(p) for p in params])
    opt = dt.adam(**hp)
    tstate = opt.init([t(p) for p in params])
    assert tstate.count == 0
    for step in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** rng.integers(-4, 2)
                  ).astype(np.float32) for s in shapes]
        jupd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate)
        tupd, tstate = opt.update([t(g) for g in grads], tstate)
        assert tstate.count == int(jstate[0].count) == step + 1
        for a, b in zip(jupd, tupd):
            # one step: the two differ in rounding only
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                       atol=1e-9)
        for a, b in zip(jstate[0].mu, tstate.mu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        for a, b in zip(jstate[0].nu, tstate.nu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_adam_carries_its_hyperparameters():
    opt = dt.adam(3e-4, b1=0.8)
    assert isinstance(opt, dt.Adam)
    assert (opt.learning_rate, opt.b1, opt.b2, opt.eps) == (3e-4, 0.8, 0.999,
                                                            1e-8)
    assert "0.0003" in repr(opt)


# -- (b) masked NLL and its gradients -------------------------------------------

@pytest.mark.parametrize("mask_kind", ["ones", "padded", "weights", "empty"])
def test_masked_nll_loss_and_gradients(cond, mask_kind):
    jd, td, x = cond
    chain = randomize(reference_chain(jd, x), 3)
    tchain = to_torch(chain)
    rng = np.random.default_rng(2)
    xb = rng.normal(size=(32, 5)).astype(np.float32)
    thb = rng.uniform(size=(32, 1)).astype(np.float32)
    mask = {"ones": np.ones(32), "padded": (np.arange(32) < 20) * 1.0,
            "weights": rng.uniform(0.1, 3.0, size=32),
            "empty": np.zeros(32)}[mask_kind].astype(np.float32)
    base = df.StandardNormal(5)
    jl, jg = jax.value_and_grad(jax_masked_nll)(
        chain, base, jnp.asarray(xb), jnp.asarray(thb), jnp.asarray(mask))
    tl = dt.masked_nll_loss(tchain, dt.StandardNormal(5), t(xb), t(thb),
                            t(mask))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    tl.backward()
    for a, b in zip(jax.tree_util.tree_leaves(jg), element_leaves(tchain)):
        if a.size and isinstance(b, torch.nn.Parameter):
            scale = float(np.abs(np.asarray(a)).max()) + 1.0
            np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                       atol=2e-5 * scale)


def test_make_train_step_equals_a_jax_step(cond):
    jd, td, x = cond
    chain = randomize(reference_chain(jd, x), 4)
    tchain = to_torch(chain)
    rng = np.random.default_rng(3)
    xb = rng.normal(size=(16, 5)).astype(np.float32)
    thb = rng.uniform(size=(16, 1)).astype(np.float32)
    mask = (np.arange(16) < 11).astype(np.float32)
    tx = optax.adam(2e-3)
    jstep = df.make_train_step(tx)
    jmodel, jstate, jloss = jstep(
        jax.tree_util.tree_map(jnp.array, chain), tx.init(chain),
        df.StandardNormal(5), jnp.asarray(xb), jnp.asarray(thb),
        jnp.asarray(mask))
    opt = dt.adam(2e-3)
    tstep = dt.make_train_step(opt)
    tmodel, tstate, tloss = tstep(
        tchain, opt.init(trainable_leaves(tchain)), dt.StandardNormal(5),
        t(xb), t(thb), t(mask))
    assert tmodel is tchain
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert_leaves_close(jmodel, tmodel, 1e-5)
    assert_opt_state_close(jstate, tmodel, tstate, 1e-5)


# -- (c) the plain program's trajectories ---------------------------------------

def _both(cond, chain_fn, epochs=4, bs=32, jax_opt=None, torch_opt=None,
          key=3, **kw):
    """Train the same flow with the JAX package (its jnp program) and with
    the port's plain program, on the JAX batch order."""
    jd, td, x = cond
    fj = df.Flow(chain_fn(jd, x), jd)
    ft = torch_flow(fj, td)
    n = len(jd.partition.training)
    perms = jax_epoch_perms(jax.random.key(key), epochs, n)
    jres = df.train(fj, jd, jax_opt, epochs=epochs, batchsize=bs,
                    verbose=False, key=jax.random.key(key),
                    fused_kernel=False, **kw)
    tres = dt.train(ft, td, torch_opt, epochs=epochs, batchsize=bs,
                    verbose=False, fused_kernel=False, _epoch_perms=perms,
                    **kw)
    assert ft.trained_path == "torch"
    return fj, ft, jres, tres


def _assert_same_run(fj, ft, jstate, tstate):
    np.testing.assert_allclose(ft.train_loss, fj.train_loss, atol=TRAIN_ATOL)
    np.testing.assert_allclose(ft.valid_loss, fj.valid_loss, atol=TRAIN_ATOL)
    assert_leaves_close(fj.model, ft.model, TRAIN_ATOL)
    assert_opt_state_close(jstate, ft.model, tstate, TRAIN_ATOL)


def test_plain_program_matches_jax_program(cond):
    fj, ft, js, ts = _both(cond, reference_chain)
    _assert_same_run(fj, ft, js, ts)
    n_batches = -(-len(cond[0].partition.training) // 32)
    assert ts.count == 4 * n_batches


def test_plain_program_weighted(cond):
    w = np.random.default_rng(7).uniform(0.2, 3.0, size=137).astype(np.float32)
    fj, ft, js, ts = _both(cond, reference_chain, weights=w)
    _assert_same_run(fj, ft, js, ts)
    # uniform weights reproduce the unweighted run
    _, fu, _, _ = _both(cond, small_chain, epochs=2)
    _, f1, _, _ = _both(cond, small_chain, epochs=2,
                        weights=np.ones(137, np.float32))
    np.testing.assert_allclose(f1.train_loss, fu.train_loss, atol=1e-6)
    with pytest.raises(ValueError, match="one entry per data row"):
        dt.train(ft, cond[1], epochs=1, verbose=False, fused_kernel=False,
                 weights=np.ones(3))


def test_plain_program_tagged_adam_against_optax(cond):
    fj, ft, js, ts = _both(cond, reference_chain,
                           jax_opt=optax.adam(3e-3, b1=0.85),
                           torch_opt=dt.adam(3e-3, b1=0.85))
    _assert_same_run(fj, ft, js, ts)


def test_plain_program_track_best(cond):
    fj, ft, jres, tres = _both(cond, small_chain, epochs=6, key=4,
                               _track_best=True)
    (js, jbest), (ts, tbest) = jres, tres
    _assert_same_run(fj, ft, js, ts)
    # compare the argmin epoch and self-consistency, not best parameters
    # across paths
    assert int(np.argmin(ft.valid_loss)) == int(np.argmin(fj.valid_loss))
    best_flow = dt.Flow(tbest, cond[1], device="cpu")
    assert tbest is not ft.model
    np.testing.assert_allclose(dt.evaluate(best_flow, cond[1], "validation"),
                               min(ft.valid_loss), atol=1e-5)


def _guard_case():
    """The JAX suite's NaN-poisoned fixture (bench.guard_parity_case): rows
    5/40/77 make several batches per epoch non-finite at batch 16."""
    import bench

    jd, build = bench.guard_parity_case(jax, df)
    td = dt.DataArrays.make(np.asarray(jd.x), rng=0)
    return jd, td, build


def test_plain_program_skip_nonfinite():
    jd, td, build = _guard_case()
    fj = build()
    ft = torch_flow(fj, td)
    perms = jax_epoch_perms(jax.random.key(3), 4, len(jd.partition.training))
    js = df.train(fj, jd, epochs=4, batchsize=16, verbose=False,
                  key=jax.random.key(3), skip_nonfinite=True,
                  fused_kernel=False)
    ts = dt.train(ft, td, epochs=4, batchsize=16, verbose=False,
                  skip_nonfinite=True, fused_kernel=False,
                  _epoch_perms=perms)
    assert ft.skipped_updates == fj.skipped_updates
    assert sum(ft.skipped_updates) > 0
    n_batches = -(-len(jd.partition.training) // 16)
    assert ts.count == int(js[0].count) == \
        4 * n_batches - sum(ft.skipped_updates)
    assert_leaves_close(fj.model, ft.model, TRAIN_ATOL)
    for leaf in trainable_leaves(ft.model):
        assert bool(torch.isfinite(leaf).all())
    # full-split evaluations include the NaN rows: NaN histories on both
    assert np.isnan(ft.train_loss).all() and np.isnan(fj.train_loss).all()


def test_debug_raises_on_nonfinite_epoch_loss():
    jd, td, build = _guard_case()
    ft = torch_flow(build(), td)
    with pytest.raises(FloatingPointError, match="non-finite"):
        dt.train(ft, td, epochs=1, batchsize=16, verbose=False, debug=True,
                 skip_nonfinite=True, generator=torch.Generator().manual_seed(0))


def test_debug_chunks_replay_one_run(cond):
    jd, td, x = cond
    fj = df.Flow(small_chain(jd, x), jd)
    n = len(jd.partition.training)
    perms = np.stack([np.random.default_rng(e).permutation(n)
                      for e in range(13)])
    fa, fb = torch_flow(fj, td), torch_flow(fj, td)
    sa = dt.train(fa, td, epochs=13, verbose=False, fused_kernel=False,
                  _epoch_perms=perms)
    sb = dt.train(fb, td, epochs=13, verbose=False, debug=True,
                  _epoch_perms=perms)
    assert fb.train_loss == fa.train_loss and sa.count == sb.count
    assert "debug" in fb.fused_decline_reason or \
        "non-CUDA" in fb.fused_decline_reason


# -- (g) routing and declines -----------------------------------------------------

def _train_module():
    # the package exports the function ``train`` under the module's name
    return sys.modules["densityflows_tpu_torch.train"]


def test_cpu_flow_never_auto_routes(cond, monkeypatch, capsys):
    jd, td, x = cond
    ft = torch_flow(df.Flow(small_chain(jd, x), jd), td)
    calls = []
    monkeypatch.setattr(_train_module(), "train_fused",
                        lambda *a, **k: calls.append(k) or 1 / 0)
    dt.train(ft, td, epochs=1, verbose=True,
             generator=torch.Generator().manual_seed(0))
    assert calls == []
    assert ft.trained_path == "torch"
    assert ft.fused_decline_reason == "non-CUDA device (cpu)"
    assert "fused-train kernel" not in capsys.readouterr().out


class _FakeCuda:
    type = "cuda"


def test_auto_routing_on_a_cuda_flow(cond, monkeypatch, capsys):
    """What "auto" does with a flow on a CUDA device, with the kernel path
    replaced by a probe (there is no card here): it tries the kernel on the
    plain surface, records every decline, and catches nothing but
    UnsupportedFusedTrain."""
    tm = _train_module()
    jd, td, x = cond
    ft = torch_flow(df.Flow(small_chain(jd, x), jd), td)
    # the flow claims a CUDA device; the plain program's arrays stay where
    # they are
    ft.device = _FakeCuda()
    monkeypatch.setattr(
        sys.modules["densityflows_tpu_torch.data"], "_as_tensor",
        lambda a, device: torch.as_tensor(a))
    calls = []

    def declines(flow, data, **k):
        calls.append(k)
        raise dt.UnsupportedFusedTrain("needs 999999 bytes (probe)")

    monkeypatch.setattr(tm, "train_fused", declines)
    kw = dict(epochs=1, batchsize=32)

    with pytest.warns(RuntimeWarning, match="999999 bytes"):
        dt.train(ft, td, verbose=True,
                 generator=torch.Generator().manual_seed(0), **kw)
    assert len(calls) == 1 and ft.trained_path == "torch"
    assert len(ft.train_loss) == 1
    assert "999999 bytes" in ft.fused_decline_reason
    out = capsys.readouterr().out
    assert out.count("fused-train kernel not used") == 1 and "999999" in out

    # not printed without verbose, but the warning is not tied to it
    with pytest.warns(RuntimeWarning, match="fused_kernel=False"):
        dt.train(ft, td, dt.adam(2e-3), verbose=False, skip_nonfinite=True,
                 generator=torch.Generator().manual_seed(0), **kw)
    assert len(calls) == 2 and calls[-1]["lr"] == 2e-3
    assert calls[-1]["skip_nonfinite"] is True
    assert "fused-train kernel" not in capsys.readouterr().out

    class Sub(dt.Adam):
        pass

    # off the kernel's surface: declined by name, the kernel is not tried
    dt.train(ft, td, Sub(), verbose=False,
             generator=torch.Generator().manual_seed(0), **kw)
    assert len(calls) == 2
    assert "optimizer other than adam" in ft.fused_decline_reason
    dt.train(ft, td, verbose=False, fused_kernel=False,
             generator=torch.Generator().manual_seed(0), **kw)
    assert len(calls) == 2

    # a failure that is not an envelope decline propagates
    def boom(*a, **k):
        raise RuntimeError("train_run launch failed (CUDA error 1)")

    monkeypatch.setattr(tm, "train_fused", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        dt.train(ft, td, verbose=False, **kw)

    # success: path recorded, reason cleared
    def ok(flow, data, **k):
        flow.train_loss.append(1.0)
        flow.valid_loss.append(1.0)
        return "state"

    monkeypatch.setattr(tm, "train_fused", ok)
    assert dt.train(ft, td, verbose=False, **kw) == "state"
    assert ft.trained_path == "fused" and ft.fused_decline_reason is None


def test_forced_kernel_surface_errors(cond, tmp_path):
    jd, td, x = cond
    ft = torch_flow(df.Flow(small_chain(jd, x), jd), td)
    kw = dict(epochs=1, verbose=False, fused_kernel=True)
    with pytest.raises(ValueError, match="plain training surface"):
        dt.train(ft, td, checkpoint_dir=str(tmp_path / "c"), **kw)
    with pytest.raises(ValueError, match="plain training surface"):
        dt.train(ft, td, early_stopping_patience=3, **kw)
    with pytest.raises(ValueError, match="plain training surface"):
        dt.train(ft, td, debug=True, **kw)

    class Sgd:
        def init(self, params):
            return None

        def update(self, grads, state, params=None):
            return [-0.01 * g for g in grads], state

    with pytest.raises(ValueError, match="built-in Adam"):
        dt.train(ft, td, Sgd(), **kw)

    class Sub(dt.Adam):
        pass

    with pytest.raises(ValueError, match="built-in Adam"):
        dt.train(ft, td, Sub(), **kw)
    with pytest.raises(ValueError, match="one entry per data row"):
        dt.train(ft, td, weights=np.ones(3), **kw)
    # the plain program takes any optimizer with init / update
    dt.train(ft, td, Sgd(), epochs=2, verbose=False, fused_kernel=False,
             generator=torch.Generator().manual_seed(0))
    assert len(ft.train_loss) == 2 and ft.train_loss[1] < ft.train_loss[0]


@pytest.mark.parametrize("kw, names", [
    pytest.param(dict(mesh=object()), "Mesh", id="kw0-A9"),
    pytest.param(dict(remat=True), "remat", id="kw1-A13"),
    pytest.param(dict(mixed_precision=True), "mixed_precision",
                 id="kw2-A13")])
def test_surfaces_not_ported_raise_by_name(cond, kw, names):
    """A mesh that is not a ``parallel.mesh.Mesh`` raises ``TypeError`` by
    name (A9, ported: the data and model axes of ``make_mesh`` train).
    remat / mixed_precision (ported with A13) are options of the plain
    program: the kernel path raises on them by name, the plain program
    runs them."""
    jd, td, x = cond
    ft = torch_flow(df.Flow(small_chain(jd, x), jd), td)
    if "mesh" in kw:
        with pytest.raises(TypeError, match=names):
            dt.train(ft, td, epochs=1, verbose=False, **kw)
        return
    with pytest.raises(ValueError, match=names):
        dt.train(ft, td, epochs=1, verbose=False, fused_kernel=True, **kw)
    dt.train(ft, td, epochs=1, verbose=False, **kw,
             generator=torch.Generator().manual_seed(0))
    assert ft.trained_path == "torch" and len(ft.train_loss) == 1
    assert callable(dt.make_train_program(dt.adam(), 32, 1, **kw))
    assert callable(dt.make_train_step(dt.adam(), **kw))


# -- (i) chunked loops, checkpoints, optimizer state across packages -------------

def test_early_stopping_restores_the_exact_best_epoch(cond):
    jd, td, x = cond
    fj = df.Flow(small_chain(jd, x), jd)
    n = len(jd.partition.training)
    perms = np.stack([np.random.default_rng(e).permutation(n)
                      for e in range(12)])
    # a large step so the validation NLL turns around inside the run
    opt = dt.adam(5e-2)
    ref = torch_flow(fj, td)
    snaps = []
    state = None
    for e in range(12):
        state = dt.train(ref, td, opt, state, epochs=1, batchsize=32,
                         verbose=False, fused_kernel=False,
                         _epoch_perms=perms[e:e + 1])
        snaps.append([p.detach().clone() for p in trainable_leaves(ref.model)])
    best_epoch = int(np.argmin(ref.valid_loss))
    assert 0 < best_epoch < 11, ref.valid_loss

    ft = torch_flow(fj, td)
    dt.train(ft, td, opt, epochs=12, batchsize=32, verbose=False,
             early_stopping_patience=100, early_stopping_check_every=5,
             _epoch_perms=perms)
    assert ft.valid_loss == ref.valid_loss
    for a, b in zip(trainable_leaves(ft.model), snaps[best_epoch]):
        assert torch.equal(a.detach(), b)
    np.testing.assert_allclose(dt.evaluate(ft, td, "validation"),
                               min(ft.valid_loss), atol=1e-5)

    # patience cuts the run short; both loops at once are refused
    f2 = torch_flow(fj, td)
    dt.train(f2, td, opt, epochs=40, batchsize=32, verbose=False,
             early_stopping_patience=2, early_stopping_check_every=2,
             generator=torch.Generator().manual_seed(1))
    assert len(f2.train_loss) < 40
    with pytest.raises(ValueError, match="separate chunked loops"):
        dt.train(f2, td, epochs=4, verbose=False, early_stopping_patience=2,
                 checkpoint_dir="x")


def test_checkpoint_resume_replays_an_uninterrupted_run(cond, tmp_path):
    jd, td, x = cond
    fj = df.Flow(small_chain(jd, x), jd)

    def gen():
        return torch.Generator().manual_seed(7)

    kw = dict(batchsize=32, verbose=False, checkpoint_every=2)
    fa = torch_flow(fj, td)
    sa = dt.train(fa, td, epochs=6, generator=gen(),
                  checkpoint_dir=str(tmp_path / "a"), **kw)
    fb = torch_flow(fj, td)
    dt.train(fb, td, epochs=4, generator=gen(),
             checkpoint_dir=str(tmp_path / "b"), **kw)
    fb2 = torch_flow(fj, td)   # a fresh process
    sb = dt.train(fb2, td, epochs=6, generator=gen(), resume=True,
                  checkpoint_dir=str(tmp_path / "b"), **kw)
    assert len(fb2.train_loss) == 6
    assert fb2.train_loss == fa.train_loss
    assert fb2.valid_loss == fa.valid_loss
    assert sa.count == sb.count
    for a, b in zip(trainable_leaves(fa.model), trainable_leaves(fb2.model)):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(sa.mu + sa.nu, sb.mu + sb.nu):
        assert torch.equal(a, b)
    # the shuffles really differ from chunk to chunk and from a one-piece run
    fc = torch_flow(fj, td)
    dt.train(fc, td, epochs=6, generator=gen(), batchsize=32, verbose=False,
             fused_kernel=False)
    assert fc.train_loss != fa.train_loss


def test_opt_state_npz_crosses_between_the_packages(cond, tmp_path):
    jd, td, x = cond
    tx = optax.adam(1e-3)
    # JAX writes, the port reads and continues; JAX continues itself
    fj = df.Flow(reference_chain(jd, x), jd)
    js = df.train(fj, jd, tx, epochs=2, batchsize=32, verbose=False,
                  key=jax.random.key(1), fused_kernel=False)
    df.save_flow(str(tmp_path / "j"), fj, js)
    ft, ts = dt.load_flow(str(tmp_path / "j"), dt.adam(), device="cpu")
    assert_opt_state_close(js, ft.model, ts, 0.0)
    assert ft.train_loss == fj.train_loss
    n = len(jd.partition.training)
    perms = jax_epoch_perms(jax.random.key(2), 2, n)
    js2 = df.train(fj, jd, tx, js, epochs=2, batchsize=32, verbose=False,
                   key=jax.random.key(2), fused_kernel=False)
    ts2 = dt.train(ft, td, dt.adam(), ts, epochs=2, batchsize=32,
                   verbose=False, fused_kernel=False, _epoch_perms=perms)
    np.testing.assert_allclose(ft.valid_loss, fj.valid_loss, atol=TRAIN_ATOL)
    assert_opt_state_close(js2, ft.model, ts2, TRAIN_ATOL)

    # the port writes, JAX reads: same leaves, same count
    dt.save_flow(str(tmp_path / "t"), ft, ts2)
    with open(tmp_path / "t" / "flow.json") as f:
        assert json.load(f)["has_opt_state"] is True
    fj_back, js_back = df.load_flow(str(tmp_path / "t"), tx)
    assert_opt_state_close(js_back, ft.model, ts2, 0.0)
    assert_leaves_close(fj_back.model, ft.model, 0.0)
    # without an optimizer, or without saved state, load_flow gives the flow
    assert isinstance(dt.load_flow(str(tmp_path / "t"), device="cpu"), dt.Flow)
    dt.save_flow(str(tmp_path / "n"), ft)
    assert isinstance(dt.load_flow(str(tmp_path / "n"), dt.adam(),
                                   device="cpu"), dt.Flow)


def test_adam_state_conversion_errors(cond):
    jd, td, x = cond
    chain = to_torch(reference_chain(jd, x))
    state = dt.adam().init(trainable_leaves(chain))
    leaves = dt.adam_state_to_jax_leaves(chain, state)
    # count + a moment pair for every model leaf, the Normalization range
    # included (zero moments on the JAX side, no moments here)
    assert len(leaves) == 1 + 2 * len(element_leaves(chain))
    assert len(state.mu) == len(element_leaves(chain)) - 2
    back = dt.adam_state_from_jax_leaves(chain, leaves)
    assert back.count == 0 and len(back.mu) == len(state.mu)
    with pytest.raises(ValueError, match="leaves"):
        dt.adam_state_from_jax_leaves(chain, leaves[:-1])
    bad = list(leaves)
    bad[1] = bad[1][:1]
    with pytest.raises(ValueError, match="shape"):
        dt.adam_state_from_jax_leaves(chain, bad)
    state.mu.pop()
    with pytest.raises(ValueError, match="trainable leaves"):
        dt.adam_state_to_jax_leaves(chain, state)
    with pytest.raises(TypeError, match="only an Adam state"):
        dt.adam_state_to_jax_leaves(chain, object())


def test_evaluate_splits_and_metrics_log(cond, tmp_path):
    jd, td, x = cond
    fj = df.Flow(randomize(reference_chain(jd, x), 5), jd)
    ft = torch_flow(fj, td)
    for split in ("training", "validation"):
        np.testing.assert_allclose(dt.evaluate(ft, td, split),
                                   df.evaluate(fj, jd, split), rtol=1e-5)
    with pytest.raises(ValueError, match="empty"):
        dt.evaluate(ft, td, "testing")
    with pytest.raises(ValueError, match="unknown split"):
        dt.evaluate(ft, td, "nope")
    jd3 = df.DataArrays.make(x, np.asarray(jd.theta), rng=0, f_training=0.7,
                             f_validation=0.1)
    td3 = dt.DataArrays.make(x, np.asarray(jd.theta), rng=0, f_training=0.7,
                             f_validation=0.1)
    np.testing.assert_allclose(dt.evaluate(ft, td3, "testing"),
                               df.evaluate(fj, jd3, "testing"), rtol=1e-5)
    p = tmp_path / "m" / "metrics.jsonl"
    for fused in (False, True):
        dt.train(ft, td, epochs=2, batchsize=32, verbose=False,
                 fused_kernel=fused, metrics_log=str(p),
                 generator=torch.Generator().manual_seed(0))
    lines = [json.loads(line) for line in open(p)]
    assert [ln["epoch"] for ln in lines] == [1, 2, 3, 4]
    assert [ln["trained_path"] for ln in lines] == ["torch"] * 2 + ["fused"] * 2
    np.testing.assert_allclose([ln["valid_nll"] for ln in lines],
                               ft.valid_loss, atol=1e-6)
    assert dt.utils.logging.MetricsLogger(str(p)).read() == lines


def test_batch_iterator_matches_the_jax_package():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    th = rng.normal(size=(10, 1)).astype(np.float32)
    for shuffle in (False, True):
        ja = list(jax_batch_iterator(x, th, 4, shuffle=shuffle,
                                     rng=np.random.default_rng(5)))
        ta = list(dt.batch_iterator(x, th, 4, shuffle=shuffle,
                                    rng=np.random.default_rng(5)))
        assert len(ja) == len(ta) == 3
        for a, b in zip(ja, ta):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    assert ta[-1][2].tolist() == [1.0, 1.0, 0.0, 0.0]


# -- (j) the density the trained flow learns ---------------------------------------

def _true_log_density(x, theta):
    """Exact log p(x|θ) of the fixture's generator (the analytic target of
    tests/test_reference_parity.py)."""
    x1, x2, x3, x4, x5 = np.asarray(x, np.float64).T
    th = np.asarray(theta, np.float64).reshape(-1)

    def lognorm(v, mu, sig):
        return -0.5 * np.log(2 * np.pi * sig**2) - 0.5 * ((v - mu) / sig) ** 2

    lp = lognorm(x1, 0.0, 1.0) + lognorm(x5, 0.0, 1.0)
    lp += lognorm(x2, np.sin(x1 / 0.8) + th, 0.3)
    lp += lognorm(x4, np.cos(x1 / 1.1) + th, 0.3)
    lp += lognorm(x3, np.exp(x1 / 1.4) / 10 - 0.1 * th, 0.1 * np.abs(th))
    return lp


def test_learned_density_matches_true_density(fixture_data):
    """The port's copy of the reference-parity test: trained with the plain
    program and early stopping, the flow's held-out NLL comes within 0.15 nat
    of the exact optimum on the same rows (paired KL estimate), and cannot
    beat it by more than Monte-Carlo noise."""
    x, theta = fixture_data
    data = dt.DataArrays.make(x, theta, rng=0)
    g = torch.Generator().manual_seed(0)
    kw = dict(hidden_dim_s=64, hidden_dim_t=64, generator=g, device="cpu")
    chain = dt.flow_chain(
        *[dt.coupling_layer(data, m, **kw) for m in
          ([0, 1, 2], [2, 3, 4], [4, 0, 1], [1, 2, 3], [3, 4, 0])],
        dt.normalization_layer(x, -1.0, 1.0, device="cpu"))
    flow = dt.Flow(chain, data, device="cpu")
    dt.train(flow, data, dt.adam(1e-3), epochs=120, verbose=False,
             generator=torch.Generator().manual_seed(1),
             early_stopping_patience=40, early_stopping_check_every=20)
    iv = np.asarray(data.partition.validation)
    xv, thv = x[iv], theta[iv]
    nll_true = -np.mean(_true_log_density(xv, thv))
    nll_model = dt.evaluate(flow, data, "validation")
    gap = nll_model - nll_true
    assert -0.10 < gap < 0.15, (nll_model, nll_true)
    lp_model = flow.log_prob(xv.astype(np.float32),
                             thv.astype(np.float32)).detach().numpy()
    corr = np.corrcoef(lp_model, _true_log_density(xv, thv))[0, 1]
    assert corr > 0.88, corr
