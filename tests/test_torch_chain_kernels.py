"""PyTorch port vs the JAX package on the CPU: the whole-chain plan, its
folded parameters, and the plain versions of the two chain kernels.

The CUDA kernels themselves cannot run here (no GPU, no nvcc); they are held
against these plain versions on the card by ``chip_smoke.py``. Here:

- plan and folded parameters equal the JAX package's ``_plan_params`` entry
  by entry;
- ``chain_apply_plain`` against the JAX Pallas kernel in interpret mode
  (``run_chain(..., interpret=True)``), tolerance 2e-5 abs+rel (f32 on both
  sides, sums in another order; 1e-4 for the 8-element mixed chain's
  forward direction, whose outputs reach O(30));
- the lowering to the kernels' program (``pack_plan``) against the plain
  version, through a PyTorch interpreter of the program;
- ``chain_sample_plain`` with injected noise against ``chain.forward_``;
- the numpy model of the in-kernel Philox generator.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import fused_chain as JF
from densityflows_tpu.models import layers as JL
from densityflows_tpu.ops import pallas_chain as JP
from densityflows_tpu_torch.models import fused_chain as TF
from densityflows_tpu_torch.ops import chain_kernels as CK

from _torch_parity import TOL, inputs, mixed_chain, randomize, t, to_torch

LOOSE = dict(rtol=1e-4, atol=1e-4)


def logit_chain(d=4, n=1):
    lo = np.zeros(d, np.float32)
    hi = np.ones(d, np.float32) * 3.0
    return randomize(df.flow_chain(
        df.coupling_layer(d, [0, 1], n=n, key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.logit_layer((lo, hi)),
    ), 21)


def odd_chain(d=7, n=3, hidden=18):
    """Widths that are no multiple of 4, no-bias nets, every activation."""
    acts = ["relu", "tanh", "sigmoid", "silu", "gelu", "softplus", "elu",
            "leaky_relu", "identity"]
    ks = jax.random.split(jax.random.key(3), len(acts))
    layers = []
    for i, (a, k) in enumerate(zip(acts, ks)):
        mask = list(range(d // 2)) if i % 2 else list(range(d // 2, d))
        layers.append(df.coupling_layer(
            d, mask, n=n, key=k, hidden_dim_s=hidden, hidden_dim_t=hidden,
            activation_s=a, activation_t=a, bias=bool(i % 3),
            n_sublayers_s=1 + i % 3, n_sublayers_t=1 + (i + 1) % 3))
    return randomize(df.flow_chain(*layers), 31)


CHAINS = {
    "mixed": (mixed_chain, 6, 2),
    "logit": (logit_chain, 4, 1),
    "odd": (odd_chain, 7, 3),
    "uncond": (lambda: mixed_chain(d=5, n=0, seed=4), 5, 0),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_plan_and_folded_params_equal_jax(name, dirn):
    build, d, n = CHAINS[name]
    chain = build()
    j_plan, j_params = JF._plan_params(chain, dirn)
    t_plan, t_params = TF._plan_params(to_torch(chain), dirn)
    assert t_plan == j_plan
    assert len(t_params) == len(j_params)
    for a, b in zip(t_params, j_params):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for op in t_plan:
        assert CK.op_param_count(op) == JP.op_param_count(op)


@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("dirn", ["fwd", "inv"])
@pytest.mark.parametrize("with_ldj", [True, False])
def test_chain_apply_plain_matches_pallas_interpret(name, dirn, with_ldj):
    build, d, n = CHAINS[name]
    chain = build()
    x, theta = inputs(d, n, 37, 5)
    if name == "logit" and dirn == "inv":
        x = (np.abs(x) + 0.2).astype(np.float32)  # inside the (0, 3) box
    j_plan, j_params = JF._plan_params(chain, dirn)
    want = JP.run_chain(j_plan, j_params, jnp.asarray(x), jnp.asarray(theta),
                        with_ldj=with_ldj, interpret=True)
    t_plan, t_params = TF._plan_params(to_torch(chain), dirn)
    got = CK.run_chain(t_plan, t_params, t(x), t(theta), with_ldj=with_ldj)
    tol = LOOSE if name in ("mixed", "uncond", "odd") else TOL
    if with_ldj:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **tol)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
        assert got[1].shape == (37,)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_packed_program_matches_plain(name, dirn):
    """The lowering the CUDA kernels execute (offsets, zero padding to
    multiples of 4, buffer routing), run by a PyTorch interpreter."""
    build, d, n = CHAINS[name]
    chain = to_torch(build())
    x, theta = inputs(d, n, 33, 6)
    if name == "logit" and dirn == "inv":
        x = (np.abs(x) + 0.2).astype(np.float32)
    plan, params = TF._plan_params(chain, dirn)
    packed = CK.pack_plan(plan, params, d, n)
    assert packed.prog.dtype == torch.int32 and packed.prog.shape[1] == 8
    assert packed.flat.dtype == torch.float32
    want = CK.chain_apply_plain(plan, params, t(x), t(theta), with_ldj=True)
    got = CK.packed_apply_reference(packed, t(x), t(theta), with_ldj=True)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **LOOSE)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **LOOSE)
    # every matrix offset and leading dimension is 16-byte aligned
    for ins in packed.prog.tolist():
        if ins[0] == 0:
            assert ins[3] % 4 == 0 and ins[4] % 4 == 0 and ins[5] % 4 == 0
            assert ins[6] == -1 or ins[6] % 4 == 0


def test_packed_plan_sizes_at_the_wide_config():
    d, n, h = 32, 8, 256
    g = torch.Generator().manual_seed(0)
    chain = dt.flow_chain(
        dt.coupling_block(d, None, n=n, generator=g, device="cpu",
                          hidden_dim_s=h, hidden_dim_t=h),
        dt.normalization_layer(
            np.random.default_rng(0).normal(size=(16, d)).astype(np.float32),
            -1.0, 1.0, device="cpu"))
    plan, params = TF._plan_params(chain, "inv")
    packed = CK.pack_plan(plan, params, d, n)
    assert packed.hmax4 == 256 and packed.ldh == 260
    assert CK.pick_tile_rows(d, n, packed.ldh) == 32
    for tb in CK.TILE_ROWS:
        assert CK.shared_memory_bytes(tb, d, n, packed.ldh) \
            <= CK.MAX_SHARED_BYTES
    # one folded net: (n+d)·H + H·H + H·d weights, 2H + d biases
    per_net = (n + d) * h + h * h + h * d + 2 * h + d
    # plus the affine op's a (d), b (d) and c (1, padded to 4)
    assert packed.flat.numel() == 4 * per_net + 2 * d + 4
    assert TF.chain_is_fusable(chain, d, n)


def test_static_limits_raise_or_decline():
    with pytest.raises(ValueError, match="too wide"):
        CK.pick_tile_rows(32, 8, 4096)
    g = torch.Generator().manual_seed(0)
    wide = dt.flow_chain(dt.coupling_layer(4, 2, generator=g, device="cpu",
                                           hidden_dim_s=4096,
                                           hidden_dim_t=8))
    # the layer types are covered, so the router does not decline: for a
    # CUDA device it raises on the width instead of running the plain path
    assert TF.chain_is_fusable(wide, 4, 0)
    with pytest.raises(ValueError, match="too wide"):
        TF._require_kernel_limits(wide, 4, 0, torch.device("cuda"))
    x, theta = inputs(4, 0, 5, 0)
    dt.set_fused_kernels(True)
    try:
        # the width is a limit of the CUDA kernels, not of the plain version
        z, ldj = TF.maybe_apply_fused(wide, t(x), t(theta), "inv", True)
        want_z, want_ldj = TF.fold_layers(wide, t(x), t(theta), "inv", True)
        # same f32 products in another order
        torch.testing.assert_close(z, want_z, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(ldj, want_ldj, rtol=2e-5, atol=2e-5)
        # float32 only: another dtype raises on any device
        with pytest.raises(TypeError, match="float32 only"):
            TF.maybe_apply_fused(wide.double(), t(x).double(),
                                 t(theta).double(), "inv", True)
        with pytest.raises(TypeError, match="float32 only"):
            TF.maybe_sample_fused(wide, g, 5, 4, None)
    finally:
        dt.set_fused_kernels("auto")


def test_unfusable_chain_keeps_the_per_layer_path():
    class Shift(torch.nn.Module):
        def forward(self, z, theta=None):
            return z + 1.0, z.new_zeros(z.shape[:-1])

        def inverse(self, x, theta=None):
            return x - 1.0, x.new_zeros(x.shape[:-1])

        def forward_(self, z, theta=None):
            return z + 1.0

    chain = dt.flow_chain(dt.actnorm_layer(3, device="cpu"), Shift())
    assert not TF.chain_is_fusable(chain, 3, 0)
    x, _ = inputs(3, 0, 4, 0)
    dt.set_fused_kernels(True)
    try:
        assert TF.maybe_apply_fused(chain, t(x), None, "fwd", False) is None
        np.testing.assert_allclose(
            chain.forward_(t(x), t(x)[:, :0]).detach().numpy(), x + 1.0)
    finally:
        dt.set_fused_kernels("auto")
    with pytest.raises(TF._Unsupported):
        TF._plan_params(chain, "fwd")


def test_auto_mode_keeps_cpu_tensors_on_the_per_layer_path():
    chain = to_torch(mixed_chain())
    x, theta = inputs(6, 2, 5, 0)
    assert TF.maybe_apply_fused(chain, t(x), t(theta), "inv", True) is None
    dt.set_fused_kernels(True)
    try:
        out = TF.maybe_apply_fused(chain, t(x), t(theta), "inv", True)
    finally:
        dt.set_fused_kernels("auto")
    ref = TF.fold_layers(chain, t(x), t(theta), "inv", True)
    np.testing.assert_allclose(out[0].detach().numpy(),
                               ref[0].detach().numpy(), **LOOSE)
    np.testing.assert_allclose(out[1].detach().numpy(),
                               ref[1].detach().numpy(), **LOOSE)


def test_chain_sample_plain_with_injected_noise_matches_forward_():
    chain = mixed_chain()
    noise, theta = inputs(6, 2, 41, 9)
    JL.set_fused_kernels(False)
    try:
        want = np.asarray(chain.forward_(jnp.asarray(noise),
                                         jnp.asarray(theta)))
        want_1 = np.asarray(chain.forward_(
            jnp.asarray(noise), jnp.broadcast_to(jnp.asarray(theta[:1]),
                                                 theta.shape)))
    finally:
        JL.set_fused_kernels("auto")
    plan, params = TF._plan_params(to_torch(chain), "fwd")
    got = CK.chain_sample_plain(plan, params, 41, 6, t(theta), noise=t(noise))
    np.testing.assert_allclose(got.numpy(), want, **LOOSE)
    # one θ row is broadcast to every draw
    got_1 = CK.chain_sample_plain(plan, params, 41, 6, t(theta[:1]),
                                  noise=t(noise))
    np.testing.assert_allclose(got_1.numpy(), want_1, **LOOSE)
    with pytest.raises(ValueError):
        CK.chain_sample_plain(plan, params, 40, 6, t(theta), noise=t(noise))


def test_run_chain_sample_on_cpu_draws_from_the_generator():
    chain = to_torch(mixed_chain())
    plan, params = TF._plan_params(chain, "fwd")
    theta = t(inputs(6, 2, 1, 0)[1])
    g = lambda: torch.Generator().manual_seed(3)
    a, noise = CK.run_chain_sample(plan, params, 50, 6, theta, generator=g(),
                                   return_noise=True)
    b = CK.run_chain_sample(plan, params, 50, 6, theta, generator=g())
    assert torch.equal(a, b) and a.shape == (50, 6)
    assert torch.equal(noise, torch.randn(50, 6, generator=g()))
    ref = CK.chain_sample_plain(plan, params, 50, 6, theta, noise=noise)
    assert torch.equal(a, ref)
    c = CK.run_chain_sample(plan, params, 50, 6, theta,
                            generator=torch.Generator().manual_seed(4))
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        CK.run_chain_sample(plan, params, 50, 6, theta.expand(7, 2))
    assert CK.launch_counts() == {"chain_apply": 0, "chain_sample": 0}


def test_run_chain_rejects_non_float32():
    chain = to_torch(logit_chain())
    plan, params = TF._plan_params(chain, "fwd")
    x, theta = inputs(4, 1, 3, 0)
    with pytest.raises(TypeError):
        CK.run_chain(plan, params, t(x).double(), t(theta), with_ldj=True)
    with pytest.raises(ValueError):
        CK.run_chain(plan, params, t(x)[0], t(theta), with_ldj=True)
    with pytest.raises(ValueError):
        CK.chain_apply_plain(plan, params[:-1], t(x), t(theta),
                             with_ldj=True)


def test_autograd_function_gradients_match_the_per_layer_path():
    chain = to_torch(mixed_chain(d=4, n=1, seed=2, hidden=8))
    x, theta = inputs(4, 1, 16, 7)

    def loss(fused):
        xx = t(x).requires_grad_(True)
        tt = t(theta).requires_grad_(True)
        chain.zero_grad()
        if fused:
            dt.set_fused_kernels(True)
            try:
                z, ldj = TF.maybe_apply_fused(chain, xx, tt, "inv", True)
            finally:
                dt.set_fused_kernels("auto")
        else:
            z, ldj = TF.fold_layers(chain, xx, tt, "inv", True)
        ((z ** 2).sum() - ldj.sum()).backward()
        return [xx.grad, tt.grad] + [p.grad for p in chain.parameters()]

    got, want = loss(True), loss(False)
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **LOOSE)


def test_plan_cache_follows_weight_updates():
    chain = to_torch(logit_chain())
    x, theta = inputs(4, 1, 6, 0)
    dt.set_fused_kernels(True)
    try:
        with torch.no_grad():
            a = TF.maybe_apply_fused(chain, t(x), t(theta), "fwd", False)
            a2 = TF.maybe_apply_fused(chain, t(x), t(theta), "fwd", False)
            chain.layers[0].t_net.biases[-1].add_(1.0)
            b = TF.maybe_apply_fused(chain, t(x), t(theta), "fwd", False)
    finally:
        dt.set_fused_kernels("auto")
    assert torch.equal(a, a2)
    ref = TF.fold_layers(chain, t(x), t(theta), "fwd", False)
    np.testing.assert_allclose(b.numpy(), ref.detach().numpy(), **TOL)
    assert not torch.allclose(a, b)


def test_philox_known_answers():
    """Random123's published test vectors for philox4x32-10."""
    zero = np.zeros((), np.uint32)
    out = CK._philox4x32_10((zero,) * 4, (zero, zero))
    assert [int(v) for v in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    ones = np.asarray(0xFFFFFFFF, np.uint32)
    out = CK._philox4x32_10((ones,) * 4, (ones, ones))
    assert [int(v) for v in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                     0x6D5451FD]


def test_philox_normal_reference_is_standard_normal_and_counter_based():
    r = CK.philox_normal_reference(1234, 20000, 5)
    assert r.shape == (20000, 5) and r.dtype == np.float32
    assert np.isfinite(r).all()
    n = r.size
    assert abs(r.mean()) < 5 / np.sqrt(n)
    assert abs(r.var() - 1) < 5 * np.sqrt(2 / n)
    assert abs((r ** 4).mean() - 3) < 5 * np.sqrt(96 / n)
    # a draw depends on (seed, row, column) only
    part = CK.philox_normal_reference(1234, 100, 5, row_offset=700)
    np.testing.assert_array_equal(part, r[700:800])
    np.testing.assert_array_equal(
        CK.philox_normal_reference(1234, 50, 4), r[:50, :4])
    assert not np.array_equal(CK.philox_normal_reference(1235, 50, 5), r[:50])
    # columns and rows are uncorrelated
    c = np.corrcoef(r.T)
    assert np.abs(c - np.eye(5)).max() < 0.05


def relu_logit_chain(d=5, n=2):
    """Relu couplings (one without bias, one of three dense layers) and a
    trailing LogitLayer over (0, 3): the two places where a hand-written
    kernel could swallow a NaN (relu as max(u, 0), the logit's clamp)."""
    ks = jax.random.split(jax.random.key(5), 3)
    kw = dict(n=n, hidden_dim_s=8, hidden_dim_t=8, activation_s="relu",
              activation_t="relu")
    return randomize(df.flow_chain(
        df.coupling_layer(d, [0, 1], key=ks[0], **kw),
        df.coupling_layer(d, [2, 3, 4], key=ks[1], bias=False, **kw),
        df.coupling_layer(d, [0, 1], key=ks[2], n_sublayers_s=2,
                          n_sublayers_t=2, **kw),
        df.logit_layer((np.zeros(d, np.float32), np.full(d, 3.0, np.float32))),
    ), 41)


def nan_rows(d, n, rows=29):
    """Rows inside the logit's box; a NaN on an identity dim of the first
    coupling (row 3), on a transformed dim (row 8) and in a condition
    (row 12)."""
    x, theta = inputs(d, n, rows, 13)
    x = (np.abs(x) % 2.6 + 0.2).astype(np.float32)
    x[3, 0] = np.nan
    x[8, 4] = np.nan
    theta[12, 1] = np.nan
    return x, theta


def assert_same_nan_pattern(got, want, **tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **tol)


@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_nan_rows_through_relu_and_logit_keep_the_jax_nan_pattern(dirn):
    """A NaN in a row stays a NaN in that row's outputs and ldj, in the
    plain chain path and in the kernels' program, as in the JAX Pallas
    kernel (interpret mode): the kernels' relu and logit clamp must keep
    it (chip_smoke.py holds the CUDA kernels to the plain version)."""
    chain = relu_logit_chain()
    x, theta = nan_rows(5, 2)
    j_plan, j_params = JF._plan_params(chain, dirn)
    want_y, want_l = JP.run_chain(j_plan, j_params, jnp.asarray(x),
                                  jnp.asarray(theta), with_ldj=True,
                                  interpret=True)
    assert np.isnan(np.asarray(want_l)).sum() == 3
    t_plan, t_params = TF._plan_params(to_torch(chain), dirn)
    got_y, got_l = CK.run_chain(t_plan, t_params, t(x), t(theta),
                                with_ldj=True)
    assert_same_nan_pattern(got_y.numpy(), want_y, **LOOSE)
    assert_same_nan_pattern(got_l.numpy(), want_l, **LOOSE)
    packed = CK.pack_plan(t_plan, t_params, 5, 2)
    ref_y, ref_l = CK.packed_apply_reference(packed, t(x), t(theta),
                                             with_ldj=True)
    assert_same_nan_pattern(ref_y.numpy(), want_y, **LOOSE)
    assert_same_nan_pattern(ref_l.numpy(), want_l, **LOOSE)


def test_nan_rows_log_prob_and_sample_keep_the_jax_nan_pattern():
    """``Flow.log_prob`` on the chain route (forced, the kernels' plain
    version on the CPU) and the per-layer route against JAX's; a NaN
    condition row through the sampler's forward fold."""
    chain = relu_logit_chain()
    x, theta = nan_rows(5, 2)
    meta = dict(hash="", d=5, n=2, theta_min=np.zeros(2),
                theta_max=np.ones(2))
    JL.set_fused_kernels(False)
    try:
        want = np.asarray(df.Flow(chain, df.MetaData(**meta)).log_prob(
            jnp.asarray(x), jnp.asarray(theta)))
        noise = inputs(5, 2, 29, 17)[0]
        want_s = np.asarray(chain.forward_(jnp.asarray(noise),
                                           jnp.asarray(theta)))
    finally:
        JL.set_fused_kernels("auto")
    assert np.isnan(want).sum() == 3 and np.isnan(want_s[12]).all()
    flow = dt.Flow(to_torch(chain), dt.MetaData(**meta), device="cpu")
    for mode in (True, False):
        dt.set_fused_kernels(mode)
        try:
            with torch.no_grad():
                got = flow.log_prob(t(x), t(theta))
        finally:
            dt.set_fused_kernels("auto")
        assert_same_nan_pattern(got.numpy(), want, **LOOSE)
    plan, params = TF._plan_params(flow.model, "fwd")
    got_s = CK.chain_sample_plain(plan, params, 29, 5, t(theta),
                                  noise=t(noise))
    assert_same_nan_pattern(got_s.numpy(), want_s, **LOOSE)
