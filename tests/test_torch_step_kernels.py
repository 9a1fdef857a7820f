"""``ops/step_kernels.py`` on the CPU: the wrapper and its plain version
(``run_fused_grads`` / ``step_grads_plain``, ``folded_nll``) against the JAX
package — ``ops.pallas_step.run_fused_grads`` in interpret mode and
``jax.grad`` of ``masked_nll_loss`` — on the same numpy inputs, and the CUDA
source ``csrc/step_kernels.cu`` itself, compiled with the host compiler in
its emulation mode (``-DDF_HOST_EMULATION``), against the plain version.

Tolerance: float32 on both sides, the same arithmetic in another summation
order: 1e-5 absolute on the loss and on every gradient entry (scaled by
1 + the largest reference entry), as stated in each test.
"""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import fused_train as JFT
from densityflows_tpu.ops import pallas_step as JS
from densityflows_tpu.train import masked_nll_loss as jax_masked_nll_loss
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.ops import step_kernels as SK
from densityflows_tpu_torch.utils.checkpoint import element_leaves

from _torch_parity import TRAIN_CHAINS as CHAINS
from _torch_parity import cond_data, randomize, to_torch

ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# layers wide enough (N >= 32) for the kernel's register-tiled weight
# gradients, at widths that are no multiple of 4
CHAINS = dict(CHAINS, wide=lambda d, x: df.flow_chain(
    df.coupling_layer(d, [0, 1, 2], key=jax.random.key(7), hidden_dim_s=34,
                      hidden_dim_t=37),
    df.coupling_layer(d, [2, 3, 4], key=jax.random.key(8), hidden_dim_s=33,
                      hidden_dim_t=33, joint_conditioner=True),
    df.normalization_layer(x, -1.0, 1.0)))
VARIANTS = ["reference", "nice", "joint", "actnorm", "permutation",
            "clamped", "nobias_tanh", "deep", "unconditional"]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


class Case:
    """One chain on both sides, folded on both sides, and one batch."""

    def __init__(self, variant, rows=45, seed=5):
        if variant == "unconditional":
            jd, td, x = cond_data(rows=90, d=4, n=0, seed=4)
            jchain = df.flow_chain(
                df.coupling_layer(jd, [0, 1], key=jax.random.key(0),
                                  hidden_dim_s=8, hidden_dim_t=8),
                df.actnorm_layer(x),
                df.coupling_layer(jd, [2, 3], key=jax.random.key(1),
                                  hidden_dim_s=8, hidden_dim_t=8,
                                  kind=df.NICECouplingLayer),
                df.normalization_layer(x, -1.0, 1.0))
        else:
            jd, td, x = cond_data()
            jchain = CHAINS[variant](jd, x)
        self.jchain = randomize(jchain, seed)
        self.chain = to_torch(self.jchain)
        self.d = x.shape[1]
        (self.plan, self.tcounts, self.tparams, self.masks, self.slots,
         self.cparams, self.fold_state, self.unfold) = \
            FT.chain_train_fold(self.chain)
        rng = np.random.default_rng(seed + 1)
        self.n = 0 if variant == "unconditional" else 1
        self.x = (rng.normal(size=(rows, self.d)) * 0.7).astype(np.float32)
        self.th = rng.uniform(size=(rows, self.n)).astype(np.float32)
        # importance weights, with padded (zero) rows at the end
        self.mask = (rng.uniform(0.2, 2.0, size=rows)
                     * (np.arange(rows) < rows - 5)).astype(np.float32)

    def head(self):
        return dict(plan=self.plan, tcounts=self.tcounts,
                    mask_slots=self.slots)

    def port(self, mask=None, denom=None, tile=None, rows=slice(None)):
        mask = self.mask if mask is None else mask
        return SK.run_fused_grads(
            _t(self.x[rows]), _t(self.th[rows]) if self.n else None,
            _t(mask[rows]), self.tparams, self.masks, self.cparams,
            denom=denom, tile=tile, **self.head())

    def unfolded(self, grads):
        """Port gradients per trainable leaf, keyed by the leaf's position
        in the checkpoint's leaf order (that of the JAX pytree)."""
        leaves = element_leaves(self.chain)
        pos = [i for i, t in enumerate(leaves)
               if isinstance(t, torch.nn.Parameter)]
        return dict(zip(pos, self.unfold(grads)))

    def assert_grads_match(self, jax_tree, grads, atol=ATOL):
        jl = jax.tree_util.tree_leaves(jax_tree)
        got = self.unfolded(grads)
        assert len(jl) == len(element_leaves(self.chain))
        checked = 0
        for i, g in got.items():
            want = np.asarray(jl[i])
            if want.size:
                scale = 1.0 + float(np.abs(want).max())
                np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                           atol=atol * scale,
                                           err_msg=f"leaf {i}")
                checked += 1
        assert checked > 0


def _jax_autograd(case, mask=None):
    mask = case.mask if mask is None else mask
    base = df.StandardNormal(case.d)
    return jax.value_and_grad(jax_masked_nll_loss)(
        case.jchain, base, jnp.asarray(case.x), jnp.asarray(case.th),
        jnp.asarray(mask))


# -- the wrapper (on the CPU: the plain version) against the JAX package ----------

@pytest.mark.parametrize("variant", VARIANTS)
def test_step_grads_equal_jax_autograd(variant):
    """Loss and unfolded gradients of one weighted, padded batch against
    ``jax.grad`` of ``masked_nll_loss`` through the JAX per-layer path: 1e-5
    (scaled). The gradients come back select-masked, and the launch counter
    does not move on CPU tensors."""
    case = Case(variant)
    before = SK.run_fused_grads.launches
    loss, grads = case.port()
    assert SK.run_fused_grads.launches == before
    want_loss, want = _jax_autograd(case)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=ATOL * (1 + abs(float(want_loss))))
    case.assert_grads_match(want, grads)
    for g, slot in zip(grads, case.slots):
        if slot is not None:
            assert bool((g[case.masks[slot] == 0] == 0).all())


@pytest.mark.parametrize("variant", ["reference", "nice", "joint", "actnorm",
                                     "permutation", "unconditional"])
def test_step_grads_equal_the_pallas_kernel_interpreted(variant):
    """Against ``densityflows_tpu.ops.pallas_step.run_fused_grads`` run as
    the JAX package's own tests run it on the CPU (interpret mode), tiled,
    with an explicit denominator: loss and unfolded gradients at 1e-5."""
    case = Case(variant)
    (jplan, jtc, jtp, jmasks, jslots, jcp, _fs, junfold) = \
        JFT.chain_train_fold(case.jchain)
    denom = float(case.mask.sum()) * 1.7
    jloss, jgrads = JS.run_fused_grads(
        jnp.asarray(case.x), jnp.asarray(case.th) if case.n else None,
        jnp.asarray(case.mask), tuple(jtp), tuple(jmasks), tuple(jcp),
        plan=jplan, tcounts=tuple(jtc), mask_slots=tuple(jslots), tile=16,
        interpret=True, denom=jnp.float32(denom))
    zero_tpl = jax.tree_util.tree_map(jnp.zeros_like, case.jchain)
    jtree = junfold(list(jgrads), zero_tpl)
    loss, grads = case.port(denom=denom, tile=16)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=ATOL * (1 + abs(float(jloss))))
    case.assert_grads_match(jtree, grads)


def test_tiling_and_shards_with_the_global_denominator_are_exact():
    """Tiles of 8 rows (a ragged last one), and two shards of the batch each
    given the GLOBAL denominator and summed, equal the whole batch at once
    (1e-5 scaled): the contract a data-parallel step rests on. With a
    shard's own denominator the sum is off by a factor."""
    case = Case("reference")
    loss, grads = case.port()
    loss_t, grads_t = case.port(tile=8)
    np.testing.assert_allclose(float(loss_t), float(loss), atol=ATOL * 10)
    denom = float(case.mask.sum())
    parts = [case.port(denom=denom, rows=sl)
             for sl in (slice(0, 20), slice(20, None))]
    np.testing.assert_allclose(float(parts[0][0] + parts[1][0]), float(loss),
                               atol=ATOL * 10)
    own = [case.port(rows=sl) for sl in (slice(0, 20), slice(20, None))]
    for k, g in enumerate(grads):
        scale = 1.0 + float(g.abs().max())
        for other in (grads_t[k], parts[0][1][k] + parts[1][1][k]):
            torch.testing.assert_close(other, g, rtol=0, atol=ATOL * scale)
    worst = max(float((own[0][1][k] + own[1][1][k] - g).abs().max())
                for k, g in enumerate(grads))
    assert worst > 1e-3


def test_grad_mask_is_a_select_and_a_masked_nan_row_poisons_like_jax():
    """An overflowing row makes off-support gradients inf: the 0/1 masks must
    give 0 there (a select), not inf·0 = NaN."""
    case = Case("reference")
    case.x[3, 0] = 3e38
    _loss, grads = case.port()
    for g, slot in zip(grads, case.slots):
        if slot is not None:
            assert bool((g[case.masks[slot] == 0] == 0).all())


@pytest.mark.parametrize("variant", ["reference", "joint", "actnorm",
                                     "unconditional"])
def test_folded_nll_equals_jax(variant):
    """``folded_nll`` against the JAX ``folded_nll`` and against the JAX
    ``masked_nll_loss``, weighted mask: 1e-5."""
    case = Case(variant)
    (jplan, jtc, jtp, _m, _s, jcp, _fs, _u) = JFT.chain_train_fold(
        case.jchain)
    want = JS.folded_nll(list(jtp), list(jcp), jnp.asarray(case.x),
                         jnp.asarray(case.th) if case.n else None,
                         jnp.asarray(case.mask), plan=jplan,
                         tcounts=tuple(jtc))
    got = SK.folded_nll(case.tparams, case.cparams, _t(case.x),
                        _t(case.th) if case.n else None, _t(case.mask),
                        plan=case.plan)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL * 10)
    np.testing.assert_allclose(float(got), float(_jax_autograd(case)[0]),
                               atol=ATOL * 10)


def test_step_plan_layout_tiles_and_errors():
    case = Case("reference")
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    flat = sp.flatten(case.tparams)
    assert flat.shape == (sp.n_params,) == (2814,)
    for a, b in zip(sp.views(flat), case.tparams):
        assert torch.equal(a, b)
    # the shared array holds one tile's rows and caches only: its size is
    # linear in the tile and holds no parameter
    per_row = sp.shared_bytes(2) - sp.shared_bytes(1)
    assert sp.shared_bytes(16) - sp.shared_bytes(8) == 8 * per_row
    assert sp.shared_bytes(8) < 4 * sp.n_params
    pk = sp.packed(8)
    assert pk.header["P"] == pk.header["G"] == pk.header["C"] == -1
    assert pk.total_floats == pk.cache_floats
    # small batches take 8-row tiles; large ones grow the tile while the
    # batch still cuts into 128 tiles
    assert sp.pick_tile(64) == 8 and sp.pick_tile(1024) == 8
    assert sp.pick_tile(2048) == 16 and sp.pick_tile(1 << 16) == 64
    assert sp.grid(64, 8) == 8 and sp.grid(1 << 20, 64) == 528
    assert sp.threads(8) == 128 and sp.threads(64) == 1024
    with pytest.raises(ValueError, match="tcounts"):
        SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                    case.cparams, case.d, case.n, (1, 2))
    with pytest.raises(ValueError, match="consumes"):
        SK.StepPlan(case.plan, case.tparams[:-1], case.masks, case.slots,
                    case.cparams, case.d, case.n)
    with pytest.raises(ValueError, match="shapes"):
        sp.flatten(case.tparams[::-1])


def test_a_conditioner_too_wide_for_one_row_declines_by_bytes(monkeypatch):
    """The envelope is the block's shared memory: a chain whose caches for
    ONE row exceed it raises, naming the bytes; a chain whose caches for 8
    rows exceed it gets a narrower tile. (The limit is lowered here so that
    a small chain shows both.)"""
    case = Case("reference")
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    monkeypatch.setattr(SK, "MAX_SHARED_BYTES", sp.shared_bytes(4) + 4)
    assert sp.pick_tile(64) == 4
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    monkeypatch.setattr(SK, "MAX_SHARED_BYTES", sp.shared_bytes(1) - 4)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sp.pick_tile(64)


# -- the CUDA source under host emulation ---------------------------------------------

def _compile_emulated(tmp_path_factory, name, defines=()):
    """``csrc/step_kernels.cu`` as plain C++ with ``defines``; ``None``
    without a host compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    out = str(tmp_path_factory.mktemp("emu") / f"lib{name}.so")
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "step_kernels.cu")
    # -ffp-contract=off: fmaf() stays the only fused multiply-add, as written
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-DDF_HOST_EMULATION", *defines, "-include",
         os.path.join(ROOT, "tests", "cuda_host_emulation.h"), "-o", out,
         src],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(out)
    lib.df_step_grads_emulated.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.df_step_grads_emulated.restype = ctypes.c_int

    def launch(threads, reverse):
        return lambda ptrs, iargs, _threads, shared_bytes, n_blocks: \
            lib.df_step_grads_emulated(ptrs, iargs, threads, shared_bytes,
                                       n_blocks, reverse)

    return launch


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/step_kernels.cu`` compiled as plain C++ (its DF_HOST_EMULATION
    mode, with tests/cuda_host_emulation.h standing in for the CUDA
    builtins): ``launch(threads, reverse)`` gives a launcher for
    ``ops.step_kernels._step_grads`` that runs both kernels' bodies on CPU
    tensors. ``reverse`` bit 0: threads of a phase last first; bit 1: blocks
    (and the reduction's items) last first."""
    launch = _compile_emulated(tmp_path_factory, "step_emulated")
    if launch is None:
        pytest.skip("needs a host C++ compiler")
    return launch


@pytest.fixture(scope="module")
def emulated_flat(tmp_path_factory):
    """The same source with flow_phases.cuh's dense instructions in place of
    its register-tiled ones (-DDF_STEP_TILED=0)."""
    launch = _compile_emulated(tmp_path_factory, "step_flat",
                               ("-DDF_STEP_TILED=0",))
    if launch is None:
        pytest.skip("needs a host C++ compiler")
    return launch


def _emulate(case, launch, mask=None, denom=None, tile=8, n_blocks=None,
             stage=None):
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    mask = case.mask if mask is None else mask
    out = SK._step_grads(
        launch, sp, sp.flatten(case.tparams), _t(case.x),
        _t(case.th) if case.n else None, _t(mask), denom=denom, tile=tile,
        n_blocks=n_blocks, stage=stage)
    return out[sp.n_params].clone(), sp.unflatten(out[:sp.n_params])


def _assert_same(got, want, atol):
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=0,
                               atol=atol * (1 + abs(float(want[0]))))
    for a, b in zip(got[1], want[1]):
        scale = 1.0 + float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=atol * scale)


@pytest.mark.parametrize("variant", ["reference", "nice", "joint", "actnorm",
                                     "permutation", "unconditional"])
def test_cuda_source_emulated_equals_the_pallas_kernel_interpreted(
        emulated, variant):
    """The CUDA source itself (grads_tile.cuh's tile body, the parameters
    staged) against ``densityflows_tpu.ops.pallas_step.run_fused_grads`` in
    interpret mode, tiles of 16 rows and an explicit denominator: loss and
    unfolded gradients at 1e-5, as the plain version is held."""
    case = Case(variant)
    (jplan, jtc, jtp, jmasks, jslots, jcp, _fs, junfold) = \
        JFT.chain_train_fold(case.jchain)
    denom = float(case.mask.sum()) * 1.7
    jloss, jgrads = JS.run_fused_grads(
        jnp.asarray(case.x), jnp.asarray(case.th) if case.n else None,
        jnp.asarray(case.mask), tuple(jtp), tuple(jmasks), tuple(jcp),
        plan=jplan, tcounts=tuple(jtc), mask_slots=tuple(jslots), tile=16,
        interpret=True, denom=jnp.float32(denom))
    jtree = junfold(list(jgrads),
                    jax.tree_util.tree_map(jnp.zeros_like, case.jchain))
    loss, grads = _emulate(case, emulated(64, 3), denom=denom, tile=16)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=ATOL * (1 + abs(float(jloss))))
    case.assert_grads_match(jtree, grads)


@pytest.mark.parametrize("variant", VARIANTS + ["sigmoid", "wide"])
def test_cuda_source_emulated_equals_plain_version(emulated, variant):
    """6 tiles of 8 rows for 45 rows (a ragged last tile, padded rows with
    mask 0), weighted mask: loss and every gradient at 1e-5 (scaled)."""
    case = Case(variant)
    _assert_same(_emulate(case, emulated(96, 0)), case.port(), ATOL)


def test_cuda_source_emulated_is_independent_of_thread_and_block_order(
        emulated):
    """No thread reads what another writes within a phase, and no block
    depends on another: threads and blocks in either order, another thread
    count, give the same bits. Fewer blocks than tiles (each block then adds
    its later tiles to its first) agree to rounding."""
    case = Case("actnorm")
    runs = [_emulate(case, emulated(nt, rev))
            for nt, rev in ((96, 0), (96, 1), (96, 2), (64, 3), (1024, 0))]
    for other in runs[1:]:
        _assert_same(other, runs[0], 0.0)
    for n_blocks in (1, 2, 4):
        a = _emulate(case, emulated(96, 0), n_blocks=n_blocks)
        b = _emulate(case, emulated(32, 3), n_blocks=n_blocks)
        _assert_same(b, a, 0.0)
        _assert_same(a, runs[0], ATOL)


def test_cuda_source_emulated_masked_tile_denominator_and_nan_row(emulated):
    """A fully masked tile contributes zeros; an explicit denominator scales
    loss and gradients; a NaN row gives the plain version's NaNs and the
    off-support entries stay 0."""
    case = Case("reference")
    mask = case.mask.copy()
    mask[8:16] = 0.0                       # the second tile of 8 rows
    launch = emulated(96, 0)
    _assert_same(_emulate(case, launch, mask=mask), case.port(mask=mask),
                 ATOL)
    denom = 3.0 * float(mask.sum())
    got = _emulate(case, launch, mask=mask, denom=denom)
    _assert_same(got, case.port(mask=mask, denom=denom), ATOL)
    one = _emulate(case, launch, mask=mask)
    np.testing.assert_allclose(float(got[0]) * 3.0, float(one[0]), rtol=1e-5)
    case.x[2, 1] = float("nan")
    got, want = _emulate(case, launch), case.port()
    assert bool(torch.isnan(got[0])) and bool(torch.isnan(want[0]))
    for a, b, slot in zip(got[1], want[1], case.slots):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        if slot is not None:
            assert bool((a[case.masks[slot] == 0] == 0).all())


@pytest.mark.parametrize("variant", ["wide", "nice", "reference"])
def test_cuda_source_emulated_tiled_dense_gives_flow_phases_bits(
        emulated, emulated_flat, variant):
    """The register-tiled weight gradients (layers of N >= 32: "wide" at 33
    to 37 columns, "nice" at 32) sum every output in flow_phases.cuh's
    order: the same bits as its b_dense, at tiles that are and are not
    multiples of their four rows (45 rows), threads in either order."""
    case = Case(variant)
    for tile in (3, 4, 8, 16):
        want = _emulate(case, emulated_flat(96, 0), tile=tile)
        got = _emulate(case, emulated(64, 3), tile=tile)
        _assert_same(got, want, 0.0)


@pytest.mark.parametrize("tile,n_blocks", [(8, None), (16, 2), (4, 5)])
def test_cuda_source_emulated_parameters_in_shared_or_device_memory(
        emulated, tile, n_blocks):
    """The residency switch: the parameters staged in shared memory (after
    the tile's floats, copied by the block first) or read from device
    memory give the same bits, at several tilings with a ragged last tile
    (45 rows), a NaN row, threads and blocks in either order; both agree
    with the plain version."""
    case = Case("deep")
    case.x[7, 2] = float("nan")
    want = case.port(tile=tile)
    runs = {}
    for stage in (True, False):
        for nt, rev in ((96, 0), (64, 3)):
            runs[stage, rev] = _emulate(case, emulated(nt, rev), tile=tile,
                                        n_blocks=n_blocks, stage=stage)
    first = runs[True, 0]
    for got in runs.values():
        assert torch.equal(got[0], first[0]) or (
            bool(torch.isnan(got[0])) and bool(torch.isnan(first[0])))
        for a, b in zip(got[1], first[1]):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])
    assert bool(torch.isnan(first[0])) and bool(torch.isnan(want[0]))
    for a, b, slot in zip(first[1], want[1], case.slots):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        if bool(ok.any()):
            torch.testing.assert_close(
                a[ok], b[ok], rtol=0,
                atol=ATOL * (1 + float(b[ok].abs().max())))
        if slot is not None:
            assert bool((a[case.masks[slot] == 0] == 0).all())


def test_launcher_is_made_once_per_shape_and_owns_no_result(emulated,
                                                           monkeypatch):
    """``StepPlan.launcher`` keeps one launcher per batch shape; a call
    returns a new buffer unless ``out=`` hands one in; the residency is
    shared memory where the parameters fit beside the tile and device
    memory where they do not; a launcher refuses another row count."""
    case = Case("reference")
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    flat = sp.flatten(case.tparams)
    launcher = sp.launcher(45)
    assert sp.launcher(45) is launcher and sp.launcher(44) is not launcher
    # 45 rows give 6 tiles of 8, fewer than 16 blocks: tiles of 4
    assert launcher.staged and launcher.tile == 4 and launcher.n_blocks == 12
    assert sp.launch_shape(1024) == (8, 128, True)
    assert sp.launch_shape(8192) == (64, 128, True)
    assert sp.shared_bytes(8, True) == 4 * (2400 + 2816 + 12 + 32 + 50 * 16)
    assert launcher.shared_bytes == sp.shared_bytes(4, True)
    args = (_t(case.x), _t(case.th), _t(case.mask))
    launch = emulated(64, 0)
    a = launcher(launch, flat, *args)
    b = launcher(launch, flat, *args)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    buf = torch.full((sp.n_params + 1,), float("nan"))
    assert launcher(launch, flat, *args, out=buf) is buf
    assert torch.equal(buf, a)
    with pytest.raises(ValueError, match="45 rows"):
        launcher(launch, flat, *(t[:40] for t in args))
    with pytest.raises(ValueError, match="out must be"):
        launcher(launch, flat, *args, out=buf[:-1])
    # on the CPU, loss_and_grads writes the plain version into ``out``
    out = torch.empty(sp.n_params + 1)
    assert sp.loss_and_grads(flat, *args, out=out) is out
    torch.testing.assert_close(out, sp.loss_and_grads(flat, *args))
    # parameters that do not fit beside the caches stay in device memory
    monkeypatch.setattr(SK, "MAX_SHARED_BYTES", sp.shared_bytes(8) + 64)
    sp = SK.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                     case.cparams, case.d, case.n, case.tcounts)
    assert sp.launch_shape(45) == (4, 12, False)
    assert not sp.launcher(45).staged
    with pytest.raises(ValueError, match="stage the parameters"):
        sp.launcher(45, stage=True)
    _assert_same(_emulate(case, launch, tile=4),
                 (a[sp.n_params], sp.unflatten(a[:sp.n_params])), 0.0)


def test_step_kernel_source_is_hand_written():
    csrc = os.path.join(ROOT, "densityflows_tpu_torch", "csrc")
    with open(os.path.join(csrc, "step_kernels.cu")) as f:
        text = f.read()
    shared = ""
    for header in ("flow_phases.cuh", "grads_tile.cuh"):
        with open(os.path.join(csrc, header)) as f:
            shared += f.read()
    for symbol in ("df_step_grads", "step_grads_kernel", "step_reduce_kernel",
                   "__global__", "#include \"flow_phases.cuh\"",
                   "#include \"grads_tile.cuh\"",
                   "#include \"async_copy.cuh\"", "df_cp_async_floats",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert symbol in text
    for symbol in ("f_dense", "b_dense", "b_couple", "loss_cotangents",
                   "row_log_prob", "put_grad", "tile_loss", "b_dense4",
                   "grads_tiles"):
        assert symbol in shared
    # the sum over tiles is per-block partials and a reduction in index
    # order, never a float atomic
    for banned in ("atomicadd", "cublas", "cudnn", "cutlass",
                   "torch/extension.h"):
        assert banned not in text.lower() and banned not in shared.lower()
