"""The port's whole-run training path (``models/fused_train.py`` →
``ops/train_kernels.py``) on the CPU against the JAX package.

On the CPU ``train(fused_kernel=True)`` runs the kernel's plain version
(``fused_train_plain``: the same run on the folded tensors with the same
hand-derived backward). It is held against the JAX package's
``train(fused_kernel=True)`` (the Pallas kernel in interpret mode, as
``tests/test_fused_train.py`` runs it) and against its ``train()`` (the jnp
program), with the same numpy data and weights and the JAX package's own
batch order injected through ``_epoch_perms``. Tolerance: ``TRAIN_ATOL`` =
1e-4 absolute, the JAX suite's own bar (float accumulation order).
"""

import jax
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models.fused_train import (
    chain_train_fold as jax_chain_train_fold)
from densityflows_tpu_torch.models import fused_chain as FC
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops import train_kernels as TK
from densityflows_tpu_torch.ops.chain_kernels import MAX_SHARED_BYTES

from _torch_parity import (
    TRAIN_ATOL, TRAIN_CHAINS as CHAINS, assert_leaves_close,
    assert_opt_state_close, cond_data, jax_epoch_perms, randomize, to_torch,
    torch_flow)

H16 = dict(hidden_dim_s=16, hidden_dim_t=16)


@pytest.fixture(scope="module")
def cond():
    return cond_data()


def _three_way(jd, td, chain_fn, x, epochs=4, bs=32, key=3, jax_opt=None,
               torch_opt=None, **kw):
    """The same run on the JAX jnp program, the JAX kernel (interpret mode)
    and the port's kernel path on the CPU."""
    def build():
        return df.Flow(chain_fn(jd, x), jd)

    f_j, f_k = build(), build()
    f_t = torch_flow(f_j, td)
    n = len(jd.partition.training)
    perms = jax_epoch_perms(jax.random.key(key), epochs, n)
    common = dict(epochs=epochs, batchsize=bs, verbose=False, **kw)
    s_j = df.train(f_j, jd, jax_opt, key=jax.random.key(key),
                   fused_kernel=False, **common)
    kernel_opt = None if torch_opt is None else df.adam(
        torch_opt.learning_rate, b1=torch_opt.b1, b2=torch_opt.b2,
        eps=torch_opt.eps)
    s_k = df.train(f_k, jd, kernel_opt, key=jax.random.key(key),
                   fused_kernel=True, **common)
    s_t = dt.train(f_t, td, torch_opt, fused_kernel=True, _epoch_perms=perms,
                   **common)
    assert f_t.trained_path == "fused" and f_t.fused_kernel_mode == "resident"
    assert f_t.fused_decline_reason is None
    return (f_j, s_j), (f_k, s_k), (f_t, s_t)


def _assert_matches(ref, got):
    (f_r, s_r), (f_t, s_t) = ref, got
    np.testing.assert_allclose(f_t.train_loss, f_r.train_loss,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(f_t.valid_loss, f_r.valid_loss,
                               atol=TRAIN_ATOL)
    assert_leaves_close(f_r.model, f_t.model, TRAIN_ATOL)
    assert_opt_state_close(s_r, f_t.model, s_t, TRAIN_ATOL)


# -- (e) the kernel path against both JAX paths -----------------------------------

@pytest.mark.parametrize("variant", sorted(CHAINS))
def test_kernel_path_matches_jax(cond, variant):
    jd, td, x = cond
    jnp_run, kernel_run, port_run = _three_way(jd, td, CHAINS[variant], x)
    _assert_matches(jnp_run, port_run)
    _assert_matches(kernel_run, port_run)
    if variant == "actnorm":
        before = [l for l in CHAINS[variant](jd, x).layers
                  if type(l).__name__ == "ActNormLayer"][0]
        after = [l for l in port_run[0].model.layers
                 if isinstance(l, dt.ActNormLayer)][0]
        assert not np.allclose(np.asarray(before.log_scale),
                               after.log_scale.detach().numpy())


def test_kernel_path_unconditional():
    jd, td, x = cond_data(rows=90, d=4, n=0, seed=4)
    chain = lambda d, xx: df.flow_chain(          # noqa: E731
        df.coupling_layer(d, [0, 1], key=jax.random.key(0), hidden_dim_s=8,
                          hidden_dim_t=8),
        df.normalization_layer(xx, -1.0, 1.0))
    jnp_run, kernel_run, port_run = _three_way(jd, td, chain, x, epochs=3)
    _assert_matches(jnp_run, port_run)
    _assert_matches(kernel_run, port_run)


def test_kernel_path_weighted(cond):
    jd, td, x = cond
    w = np.random.default_rng(7).uniform(0.2, 3.0, size=137).astype(np.float32)
    jnp_run, kernel_run, port_run = _three_way(jd, td, CHAINS["reference"], x,
                                               weights=w)
    _assert_matches(jnp_run, port_run)
    _assert_matches(kernel_run, port_run)


def test_kernel_path_tagged_adam(cond):
    import optax

    jd, td, x = cond
    jnp_run, kernel_run, port_run = _three_way(
        jd, td, CHAINS["reference"], x, jax_opt=optax.adam(3e-4, b1=0.85),
        torch_opt=dt.adam(3e-4, b1=0.85))
    _assert_matches(jnp_run, port_run)
    _assert_matches(kernel_run, port_run)


def test_kernel_path_skip_nonfinite():
    import bench

    jd, build = bench.guard_parity_case(jax, df)
    td = dt.DataArrays.make(np.asarray(jd.x), rng=0)
    f_j, f_k = build(), build()
    f_t = torch_flow(f_j, td)
    perms = jax_epoch_perms(jax.random.key(3), 4, len(jd.partition.training))
    kw = dict(epochs=4, batchsize=16, verbose=False, skip_nonfinite=True)
    s_j = df.train(f_j, jd, key=jax.random.key(3), fused_kernel=False, **kw)
    s_k = df.train(f_k, jd, key=jax.random.key(3), fused_kernel=True, **kw)
    s_t = dt.train(f_t, td, fused_kernel=True, _epoch_perms=perms, **kw)
    assert f_t.skipped_updates == f_j.skipped_updates == f_k.skipped_updates
    assert sum(f_t.skipped_updates) > 0
    n_batches = -(-len(jd.partition.training) // 16)
    assert s_t.count == int(s_j[0].count) == int(s_k[0].count) == \
        4 * n_batches - sum(f_t.skipped_updates)
    for ref in (f_j, f_k):
        assert_leaves_close(ref.model, f_t.model, TRAIN_ATOL)
    for leaf in trainable_leaves(f_t.model):
        assert bool(torch.isfinite(leaf).all())
    assert np.isnan(f_t.train_loss).all()
    # a healthy guarded run counts no skips and equals the unguarded one
    jd2, td2, x2 = cond_data()
    fa = torch_flow(df.Flow(CHAINS["reference"](jd2, x2), jd2), td2)
    fb = torch_flow(df.Flow(CHAINS["reference"](jd2, x2), jd2), td2)
    p = jax_epoch_perms(jax.random.key(4), 3, len(jd2.partition.training))
    dt.train(fa, td2, epochs=3, batchsize=32, verbose=False,
             fused_kernel=True, skip_nonfinite=True, _epoch_perms=p)
    dt.train(fb, td2, epochs=3, batchsize=32, verbose=False,
             fused_kernel=True, _epoch_perms=p)
    assert fa.skipped_updates == [0, 0, 0]
    assert fa.train_loss == fb.train_loss


def test_kernel_path_track_best(cond):
    jd, td, x = cond
    chain = lambda d, xx: df.flow_chain(          # noqa: E731
        df.coupling_layer(d, [0, 1, 2], key=jax.random.key(0), **H16),
        df.normalization_layer(xx, -1.0, 1.0))
    f_j = df.Flow(chain(jd, x), jd)
    f_t = torch_flow(f_j, td)
    perms = jax_epoch_perms(jax.random.key(4), 6, len(jd.partition.training))
    df.train(f_j, jd, epochs=6, batchsize=32, verbose=False,
             key=jax.random.key(4), _track_best=True, fused_kernel=True)
    s_t, best = FT.train_fused(f_t, td, epochs=6, batchsize=32, verbose=False,
                               track_best=True, _epoch_perms=perms)
    np.testing.assert_allclose(f_t.valid_loss, f_j.valid_loss,
                               atol=TRAIN_ATOL)
    # the argmin epoch and self-consistency, not best parameters across paths
    assert int(np.argmin(f_t.valid_loss)) == int(np.argmin(f_j.valid_loss))
    assert best is not f_t.model
    np.testing.assert_allclose(
        dt.evaluate(dt.Flow(best, td, device="cpu"), td, "validation"),
        min(f_t.valid_loss), atol=1e-5)


# -- (f) continuation ---------------------------------------------------------------

def test_cross_path_continuation(cond):
    """fused → plain → fused with the carried opt_state equals the all-plain
    run and the JAX package's."""
    jd, td, x = cond
    f_j = df.Flow(CHAINS["actnorm"](jd, x), jd)
    f_ref, f_mix = torch_flow(f_j, td), torch_flow(f_j, td)
    n = len(jd.partition.training)
    s_j = s_ref = s_mix = None
    for stage, fused in enumerate((True, False, True)):
        key = jax.random.key(10 + stage)
        perms = jax_epoch_perms(key, 2, n)
        kw = dict(epochs=2, batchsize=32, verbose=False)
        s_j = df.train(f_j, jd, None, s_j, key=key, fused_kernel=False, **kw)
        s_ref = dt.train(f_ref, td, None, s_ref, fused_kernel=False,
                         _epoch_perms=perms, **kw)
        s_mix = dt.train(f_mix, td, None, s_mix, fused_kernel=fused,
                         _epoch_perms=perms, **kw)
        assert f_mix.trained_path == ("fused" if fused else "torch")
    assert s_mix.count == s_ref.count == int(s_j[0].count)
    np.testing.assert_allclose(f_mix.valid_loss, f_ref.valid_loss,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(f_mix.valid_loss, f_j.valid_loss,
                               atol=TRAIN_ATOL)
    assert_opt_state_close(s_j, f_mix.model, s_mix, TRAIN_ATOL)


def test_two_calls_equal_one_call_bit_for_bit():
    """count, mu, nu and sliced permutations carried from one call into the
    next reproduce the single call exactly — with weights, the guard (real
    skips exercise the count carry) and track_best riding along."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    x[[5, 40, 77], 1] = np.nan
    w = rng.uniform(0.3, 2.0, size=120).astype(np.float32)
    jd = df.DataArrays.make(x, rng=0)
    td = dt.DataArrays.make(x, rng=0)
    f_j = df.Flow(df.flow_chain(
        df.coupling_layer(jd, [0, 1], key=jax.random.key(0), hidden_dim_s=8,
                          hidden_dim_t=8),
        df.coupling_layer(jd, [2, 3], key=jax.random.key(1), hidden_dim_s=8,
                          hidden_dim_t=8)), jd)
    n = len(jd.partition.training)
    perms = np.stack([np.random.default_rng(e).permutation(n)
                      for e in range(9)])
    kw = dict(batchsize=16, verbose=False, weights=w, skip_nonfinite=True,
              fused_kernel=True)
    f_a = torch_flow(f_j, td)
    s_a = dt.train(f_a, td, epochs=9, _epoch_perms=perms, **kw)
    f_b = torch_flow(f_j, td)
    s_b = dt.train(f_b, td, epochs=4, _epoch_perms=perms[:4], **kw)
    s_b = dt.train(f_b, td, None, s_b, epochs=5, _epoch_perms=perms[4:], **kw)

    def same(a, b):
        return all((u == v) or (np.isnan(u) and np.isnan(v))
                   for u, v in zip(a, b))

    assert same(f_a.train_loss, f_b.train_loss)
    assert same(f_a.valid_loss, f_b.valid_loss)
    assert f_a.skipped_updates == f_b.skipped_updates
    assert sum(f_b.skipped_updates) > 0
    assert s_a.count == s_b.count
    for u, v in zip(trainable_leaves(f_a.model) + s_a.mu + s_a.nu,
                    trainable_leaves(f_b.model) + s_b.mu + s_b.nu):
        assert torch.equal(u.detach(), v.detach())


# -- (d) the fold ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(CHAINS))
def test_fold_unfold_round_trip_and_masks(cond, variant):
    jd, td, x = cond
    jchain = randomize(CHAINS[variant](jd, x), 9)
    chain = to_torch(jchain)
    (plan, tcounts, tparams, masks, mask_slots, cparams, fold_state,
     unfold) = FT.chain_train_fold(chain)
    assert len(tparams) == sum(tcounts) == len(mask_slots)
    assert len(plan) == len(tcounts)
    assert all(op[1] != "packed" for op in plan if op[0] == "coupling")
    # unfold(fold(chain)) gives every trainable leaf back bit for bit
    leaves = trainable_leaves(chain)
    for a, b in zip(unfold(tparams), leaves):
        assert a.shape == b.shape and torch.equal(a, b.detach())
    # fold_state uses the same embedding
    values = [torch.full_like(p, float(i + 1)) for i, p in enumerate(leaves)]
    for a, b in zip(unfold(fold_state(values)), values):
        assert torch.equal(a, b)
    # masks are 0/1, mark exactly the support of the embedding, and the
    # folded tensors are zero off it
    ones = fold_state([torch.ones_like(p) for p in leaves])
    for k, slot in enumerate(mask_slots):
        if slot is None:
            assert bool((ones[k] == 1).all())
        else:
            m = masks[slot]
            assert m.shape == tparams[k].shape
            assert set(m.unique().tolist()) <= {0.0, 1.0}
            assert torch.equal(m, ones[k])
            assert bool((tparams[k][m == 0] == 0).all())


def test_fold_against_the_jax_fold_where_the_layouts_agree(cond):
    """joint / NICE / ActNorm / Normalization fold to the JAX package's own
    tensors (a split RNVP does not: the JAX package packs its two nets into
    one, the port keeps them apart as kind "nvp")."""
    jd, td, x = cond
    for variant in ("joint", "nice", "actnorm"):
        jchain = randomize(CHAINS[variant](jd, x), 2)
        j = jax_chain_train_fold(jchain)
        p = FT.chain_train_fold(to_torch(jchain))
        if variant != "actnorm":     # its first layer is a split RNVP
            assert p[0] == j[0] and p[1] == j[1] and p[4] == j[4]
            for a, b in zip(j[2] + j[3], p[2] + p[3]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(j[5], p[5]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    # a split RNVP is two nets
    plan = FT.chain_train_fold(to_torch(CHAINS["reference"](jd, x)))[0]
    assert [op[1] for op in plan if op[0] == "coupling"] == ["nvp"] * 3


@pytest.mark.parametrize("n,identity", [(2, True), (2, False), (0, True)],
                         ids=["theta-id", "theta", "id"])
@pytest.mark.parametrize("kind", ["nvp", "joint", "nice"])
def test_serving_and_training_plans_fold_a_coupling_alike(kind, n, identity):
    """The chain kernels' plan in the inverse direction and the training
    plan fold a coupling to the same op and the same tensors, bit for bit
    (a coupling with neither θ nor an identity block is declined by both)."""
    d = 5
    g = torch.Generator().manual_seed(7)
    kw = dict(n=n, generator=g, device="cpu", hidden_dim_s=6, hidden_dim_t=6)
    if kind == "nvp":
        kw.update(max_log_scale=1.5)
    elif kind == "joint":
        kw.update(joint_conditioner=True, max_log_scale=2.0)
    else:
        kw.update(kind=dt.NICECouplingLayer)
    mask = [0, 3] if identity else list(range(d))
    chain = dt.flow_chain(dt.coupling_layer(d, mask, **kw))
    with torch.no_grad():  # no zero biases or final layers to hide a slip
        for p in chain.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    plan, params = FC._plan_params(chain, "inv")
    t_plan, tcounts, tparams = FT.chain_train_fold(chain)[:3]
    assert plan == t_plan and plan[0][1] == kind
    assert plan[0][9:11] == (n > 0, identity)
    assert tcounts == (len(params),) == (len(tparams),)
    for p, q in zip(params, tparams):
        assert p.dtype == q.dtype == torch.float32
        assert torch.equal(p, q)


def test_permutation_folds_into_index_maps(cond):
    """The kernel never permutes: a chain with permutations has no op for
    them, and its folded log-density equals the per-layer one."""
    jd, td, x = cond
    chain = to_torch(randomize(CHAINS["permutation"](jd, x), 3))
    plan, _tc, tparams, _m, _s, cparams, _f, _u = FT.chain_train_fold(chain)
    assert [op[0] for op in plan] == ["coupling", "coupling", "affine",
                                      "coupling"]
    rng = np.random.default_rng(0)
    xb = torch.as_tensor(rng.normal(size=(16, 5)).astype(np.float32))
    thb = torch.as_tensor(rng.uniform(size=(16, 1)).astype(np.float32))
    z, ldj = chain.inverse(xb, thb)
    want = dt.StandardNormal(5).log_prob(z) + ldj
    got = TK._folded_log_prob(plan, tparams, cparams, xb, thb)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=2e-5)


# -- (g) declines of the fold and the envelope --------------------------------------------

def test_unsupported_chains_raise(cond):
    jd, td, x = cond
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device="cpu", n=1)
    cases = {
        "InvertibleLinearLayer": dt.flow_chain(
            dt.coupling_layer(5, [0, 1, 2], **kw),
            dt.invertible_linear_layer(5, generator=g, device="cpu")),
        "LogitLayer": dt.flow_chain(
            dt.coupling_layer(5, [0, 1, 2], **kw),
            dt.logit_layer(x, margin=0.1, device="cpu")),
        "activation 'gelu'": dt.flow_chain(
            dt.coupling_layer(5, [0, 1, 2], activation_s="gelu", **kw)),
        "no trainable layers": dt.flow_chain(
            dt.normalization_layer(x, -1.0, 1.0, device="cpu")),
    }
    for needle, chain in cases.items():
        flow = dt.Flow(chain, td, device="cpu")
        with pytest.raises(dt.UnsupportedFusedTrain, match=needle):
            dt.train(flow, td, epochs=1, verbose=False, fused_kernel=True)
        assert flow.train_loss == []     # nothing ran, nothing changed
    with pytest.raises(dt.UnsupportedFusedTrain, match="FlowChain"):
        FT.chain_train_fold(dt.coupling_layer(5, [0, 1, 2], **kw))
    assert issubclass(dt.UnsupportedFusedTrain, ValueError)


def test_exact_shared_memory_budget_declines_a_wide_chain(cond,
                                                         monkeypatch):
    """The envelope is the block's shared memory, computed exactly from the
    lowered plan: the reference config fits, hidden 256 at d 32 does not and
    the message carries the byte counts. Such a chain trains in the stream
    mode (``train_stream``'s envelope is the caches of one row); with that
    limit lowered below one row it declines with both reasons and nothing
    runs."""
    from densityflows_tpu_torch.ops import stream_kernels as SKM

    jd, td, x = cond
    chain = to_torch(CHAINS["reference"](jd, x))
    plan, _tc, tparams, masks, slots, cparams, _f, _u = \
        FT.chain_train_fold(chain)
    packed = TK.pack_train_plan(plan, tparams, masks, slots, cparams, 5, 1, 64)
    assert packed.shared_bytes == 4 * packed.total_floats
    assert packed.n_params == sum(p.numel() for p in tparams)
    assert 4 * 4 * packed.n_params < packed.shared_bytes <= MAX_SHARED_BYTES
    FT._check_budget(packed)

    rng = np.random.default_rng(0)
    xw = rng.normal(size=(300, 32)).astype(np.float32)
    thw = rng.uniform(size=(300, 8)).astype(np.float32)
    data = dt.DataArrays.make(xw, thw, rng=0)

    def wide():
        return dt.Flow(dt.flow_chain(
            dt.coupling_block(data, None, hidden_dim_s=256, hidden_dim_t=256,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu"),
            dt.normalization_layer(xw, -1.0, 1.0, device="cpu")), data,
            device="cpu")

    plan_w, _tc, tp_w, masks_w, slots_w, c_w, _f, _u = \
        FT.chain_train_fold(wide().model)
    n_folded = sum(p.numel() for p in tp_w)
    with pytest.raises(dt.UnsupportedFusedTrain) as err:
        FT._check_budget(TK.pack_train_plan(plan_w, tp_w, masks_w, slots_w,
                                            c_w, 32, 8, 64))
    msg = str(err.value)
    assert str(MAX_SHARED_BYTES) in msg and "bytes of shared memory" in msg
    assert str(16 * n_folded) in msg

    streamed = wide()
    dt.train(streamed, data, epochs=1, verbose=False, fused_kernel=True)
    assert streamed.fused_kernel_mode == "stream"
    assert len(streamed.valid_loss) == 1

    declined = wide()
    monkeypatch.setattr(SKM, "MAX_SHARED_BYTES", 1000)
    with pytest.raises(dt.UnsupportedFusedTrain) as err:
        dt.train(declined, data, epochs=1, verbose=False, fused_kernel=True)
    msg = str(err.value)
    assert str(16 * n_folded) in msg and "train_stream needs" in msg
    assert declined.train_loss == []


def test_fused_surface_errors(cond):
    jd, td, x = cond
    flow = torch_flow(df.Flow(CHAINS["reference"](jd, x), jd), td)
    with pytest.raises(dt.UnsupportedFusedTrain, match="Adam state"):
        FT.train_fused(flow, td, epochs=1, verbose=False, opt_state=object())
    with pytest.raises(ValueError, match="epoch_perms must have shape"):
        FT.train_fused(flow, td, epochs=2, verbose=False,
                       _epoch_perms=np.zeros((2, 3), np.int64))
    empty = dt.DataArrays.make(x, np.asarray(jd.theta), rng=0,
                               f_training=1.0, f_validation=0.0)
    with pytest.raises(dt.UnsupportedFusedTrain, match="empty"):
        FT.train_fused(flow, empty, epochs=1, verbose=False)


def test_draw_epoch_perms():
    g = torch.Generator().manual_seed(3)
    a = FT.draw_epoch_perms(g, 4, 10)
    assert a.shape == (4, 10)
    assert all(sorted(row.tolist()) == list(range(10)) for row in a)
    assert len({tuple(row) for row in a.tolist()}) > 1
    b = FT.draw_epoch_perms(torch.Generator().manual_seed(3), 4, 10)
    np.testing.assert_array_equal(a, b)
    c = FT.draw_epoch_perms(None, 2, 5, shuffle=False)
    assert c.tolist() == [list(range(5))] * 2
