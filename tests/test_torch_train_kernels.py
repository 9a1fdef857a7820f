"""``ops/train_kernels.py`` on the CPU: the kernel's plain version
(``fused_train_plain``) against autograd, the lowering of a plan to the
kernel's program (``pack_train_plan`` + ``packed_train_reference``) against
the plain version, and the CUDA source itself, compiled with the host
compiler in its emulation mode (``-DDF_HOST_EMULATION``) and run against the
plain version.

The plain version, the lowered program and the kernel do the same f32
arithmetic in another summation order; tolerance 1e-4 absolute on
parameters, moments and histories after 3 epochs (in practice ~1e-6), the
bar ``chip_smoke.py`` holds the kernel to on the card.
"""

import copy
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops import train_kernels as TK

from _torch_parity import TRAIN_CHAINS as CHAINS
from _torch_parity import assert_leaves_close, cond_data, randomize, to_torch

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


class Case:
    """A folded chain, its data split and a batch order."""

    def __init__(self, variant, epochs=3, bs=32, n_cond=1, seed=5):
        if n_cond:
            jd, td, x = cond_data()
            jchain = CHAINS[variant](jd, x)
        else:
            jd, td, x = cond_data(rows=90, d=4, n=0, seed=4)
            jchain = df.flow_chain(
                df.coupling_layer(jd, [0, 1], key=jax.random.key(0),
                                  hidden_dim_s=8, hidden_dim_t=8),
                df.actnorm_layer(x),
                df.coupling_layer(jd, [2, 3], key=jax.random.key(1),
                                  hidden_dim_s=8, hidden_dim_t=8,
                                  kind=df.NICECouplingLayer),
                df.normalization_layer(x, -1.0, 1.0))
        self.jchain = randomize(jchain, seed)
        self.chain = to_torch(self.jchain)
        self.flow = dt.Flow(self.chain, td, device="cpu")
        (self.plan, self.tcounts, self.tparams, self.masks, self.slots,
         self.cparams, self.fold_state, self.unfold) = \
            FT.chain_train_fold(self.chain)
        xt, tht = td.normalized_training_data(self.flow.metadata)
        xv, thv = td.normalized_validation_data(self.flow.metadata)
        self.d, self.n, self.bs = xt.shape[1], tht.shape[1], bs
        self.data = (_t(xt), _t(tht) if self.n else None, _t(xv),
                     _t(thv) if self.n else None)
        rng = np.random.default_rng(seed)
        self.perms = np.stack([rng.permutation(xt.shape[0])
                               for _ in range(epochs)])
        self.w = _t(rng.uniform(0.3, 2.0, size=xt.shape[0]))
        self.wv = _t(rng.uniform(0.3, 2.0, size=xv.shape[0]))
        self.zeros = [torch.zeros_like(p) for p in self.tparams]
        self.packed = TK.pack_train_plan(self.plan, self.tparams, self.masks,
                                         self.slots, self.cparams, self.d,
                                         self.n, bs)

    def head(self):
        return (self.plan, self.tparams, self.masks, self.slots, self.cparams)

    def plain(self, mu=None, nu=None, perms=None, tparams=None, **kw):
        return TK.fused_train_plain(
            self.plan, tparams or self.tparams, self.masks, self.slots,
            self.cparams, mu or self.zeros, nu or self.zeros, *self.data,
            self.perms if perms is None else perms, batchsize=self.bs, **kw)


def _assert_runs_close(a, b, atol=ATOL):
    for i in (0, 1, 2):
        for u, v in zip(a[i], b[i]):
            torch.testing.assert_close(u, v, rtol=0, atol=atol)
    for i in (3, 4):
        torch.testing.assert_close(a[i], b[i], rtol=0, atol=atol,
                                   equal_nan=True)
    assert (a[5] is None) == (b[5] is None)
    if a[5] is not None:
        for u, v in zip(a[5], b[5]):
            torch.testing.assert_close(u, v, rtol=0, atol=atol)
    assert (a[6] is None) == (b[6] is None)
    if a[6] is not None:
        assert a[6].tolist() == b[6].tolist()


MODES = {
    "plain": {},
    "weighted_best": dict(weighted=True, track_best=True),
    "guard_tagged": dict(guard_nonfinite=True, lr=3e-3, b1=0.85, count0=7),
}


def _mode_kwargs(case, mode):
    kw = dict(MODES[mode])
    if kw.pop("weighted", False):
        kw.update(w=case.w, w_valid=case.wv)
    return kw


# -- the hand-derived backward against autograd ------------------------------------

@pytest.mark.parametrize("variant", sorted(CHAINS) + ["unconditional"])
def test_folded_gradients_equal_autograd(variant):
    """One batch: the folded gradients, masked and unfolded, equal
    ``torch.autograd.grad`` of ``masked_nll_loss`` through the per-layer
    path. Covers the −j̄ coupling into s̄, the clamp factor, ActNorm, NICE,
    joint heads, bias-free nets, permutation folding and n = 0."""
    case = Case(variant if variant != "unconditional" else "reference",
                n_cond=variant != "unconditional")
    rng = np.random.default_rng(1)
    xb = _t(rng.normal(size=(24, case.d)) * 0.7)
    thb = _t(rng.uniform(size=(24, case.n))) if case.n else None
    mask = _t(rng.uniform(0.0, 2.0, size=24) * (np.arange(24) < 20))
    loss, grads = TK.folded_batch_grads(case.plan, case.tparams, case.cparams,
                                        xb, thb, mask)
    grads = [g if s is None else torch.where(case.masks[s] > 0.5, g,
                                             torch.zeros_like(g))
             for g, s in zip(grads, case.slots)]
    th_in = thb if thb is not None else xb.new_zeros(24, 0)
    want = dt.masked_nll_loss(case.chain, dt.StandardNormal(case.d), xb,
                              th_in, mask)
    np.testing.assert_allclose(float(loss), float(want.detach()), rtol=1e-5)
    leaves = [p for p in trainable_leaves(case.chain) if p.numel()]
    auto = torch.autograd.grad(want, leaves)
    got = [g for g, p in zip(case.unfold(grads), trainable_leaves(case.chain))
           if p.numel()]
    assert len(got) == len(auto)
    for a, b in zip(got, auto):
        scale = float(b.abs().max()) + 1.0
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * scale)


def test_grad_mask_is_a_select_not_a_multiply():
    """An off-support gradient that overflowed must become 0, not inf·0 =
    NaN: the folded zero pattern survives a step with an inf in it."""
    case = Case("reference")
    xt, tht, xv, thv = case.data
    xt = xt.clone()
    xt[case.perms[0][0], 0] = 3e38     # overflows products with it
    out = TK.fused_train_plain(*case.head(), case.zeros, case.zeros, xt, tht,
                               xv, thv, case.perms[:1], batchsize=case.bs)
    for p, slot in zip(out[0], case.slots):
        if slot is not None:
            off = case.masks[slot] == 0
            assert bool((p[off] == 0).all())


# -- (h) the lowered program against the plain version -----------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", ["reference", "joint", "nice", "actnorm",
                                     "permutation", "clamped", "deep",
                                     "nobias_tanh", "unconditional"])
def test_lowered_program_equals_plain_version(variant, mode):
    case = Case(variant if variant != "unconditional" else "reference",
                n_cond=variant != "unconditional")
    kw = _mode_kwargs(case, mode)
    want = case.plain(**kw)
    got = TK.packed_train_reference(case.packed, case.tparams, case.zeros,
                                    case.zeros, *case.data, case.perms, **kw)
    _assert_runs_close(got, want)
    assert bool(torch.isfinite(want[3]).all())


def test_lowered_batch_gradients_cover_every_entry():
    """Every entry of the flat gradient is written by the backward program
    (it starts as NaN), and equals the plain version's."""
    case = Case("actnorm")
    xt, tht, _xv, _thv = case.data
    rows = torch.as_tensor(case.perms[0][:case.bs])
    mask = torch.ones(case.bs)
    loss, flat_g = TK.packed_batch_grads(
        case.packed, case.packed.flatten(case.tparams), xt[rows], tht[rows],
        mask)
    assert bool(torch.isfinite(flat_g).all())
    want_loss, want = TK.folded_batch_grads(case.plan, case.tparams,
                                            case.cparams, xt[rows], tht[rows],
                                            mask)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=1e-6)
    for a, b in zip(case.packed.unflatten(flat_g), want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_packed_plan_layout():
    case = Case("reference", bs=64)
    pk = case.packed
    assert pk.prog.dtype == torch.int32
    assert pk.prog.numel() == TK._HEADER_WORDS + TK._INSTR_WORDS * (
        pk.n_fwd + pk.n_bwd)
    words = pk.prog.tolist()
    assert words[TK._H_NP] == pk.n_params == 2814
    assert words[TK._H_B] == 64 and words[TK._H_D] == 5 and words[TK._H_N] == 1
    assert words[TK._H_TOTAL] == pk.total_floats
    assert pk.shared_bytes == 4 * pk.total_floats
    # parameters, both moments and gradients, then the caches
    assert pk.total_floats == 4 * pk.n_params + pk.flat_consts.numel() \
        + pk.cache_floats
    # three couplings of two three-layer nets: 6 dense + 1 couple each, + affine
    assert pk.n_fwd == 3 * 7 + 1
    # backward: per coupling 1 couple + 2 nets x (2 layers + 2 first-layer
    # blocks), + affine
    assert pk.n_bwd == 3 * 9 + 1
    # every buffer offset an instruction names lies inside the block's memory
    body = np.asarray(words[TK._HEADER_WORDS:]).reshape(-1, TK._INSTR_WORDS)
    assert body.max() < 2**31 and body[:, 0].max() <= TK._B_AFFINE
    assert pk.flat_mask.shape == (pk.n_params,)
    assert 0 < int(pk.flat_mask.sum()) < pk.n_params
    flat = pk.flatten(case.tparams)
    for a, b in zip(pk.unflatten(flat), case.tparams):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="folded tensors"):
        pk.flatten(case.tparams[:-1])


def test_pad_epoch_perms_and_wrapper_errors():
    idx = TK.pad_epoch_perms(np.array([[2, 0, 1, 3, 4]] * 2), 5, 4)
    assert idx.dtype == np.int32 and idx.shape == (2, 8)
    assert idx[0].tolist() == [2, 0, 1, 3, 4, 0, 0, 0]
    with pytest.raises(ValueError, match="shape"):
        TK.pad_epoch_perms(np.zeros((2, 4), int), 5, 4)
    with pytest.raises(ValueError, match="out of range"):
        TK.pad_epoch_perms(np.full((1, 5), 5), 5, 4)
    case = Case("reference")
    # on CPU tensors the wrapper runs the plain version and launches nothing
    before = TK.run_fused_train.launches
    got = TK.run_fused_train(*case.head(), case.zeros, case.zeros, *case.data,
                             case.perms, batchsize=case.bs)
    assert TK.run_fused_train.launches == before
    _assert_runs_close(got, case.plain(), atol=0.0)
    with pytest.raises(ValueError, match="consumes"):
        TK.fused_train_plain(case.plan, case.tparams[:-1], case.masks,
                             case.slots, case.cparams, case.zeros, case.zeros,
                             *case.data, case.perms, batchsize=case.bs)
    with pytest.raises(ValueError, match="does not support op"):
        TK.train_op_param_count(("linear",))


def test_continuation_of_the_plain_version_is_exact():
    case = Case("actnorm", epochs=5)
    kw = dict(guard_nonfinite=True, w=case.w, w_valid=case.wv)
    one = case.plain(**kw)
    a = case.plain(perms=case.perms[:2], **kw)
    n_batches = -(-case.data[0].shape[0] // case.bs)
    b = case.plain(tparams=a[0], mu=a[1], nu=a[2], perms=case.perms[2:],
                   count0=2 * n_batches - int(a[6].sum()), **kw)
    for i in (0, 1, 2):
        for u, v in zip(one[i], b[i]):
            assert torch.equal(u, v)
    assert torch.equal(one[3], torch.cat([a[3], b[3]]))
    assert torch.equal(one[4], torch.cat([a[4], b[4]]))


# -- the CUDA source under host emulation ---------------------------------------------

def _compile_emulated(tmp_path_factory, flags=()):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = str(tmp_path_factory.mktemp("emu") / "libtrain_emulated.so")
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "train_kernels.cu")
    # -ffp-contract=off: fmaf() stays the only fused multiply-add, as written
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-DDF_HOST_EMULATION", *flags, "-include",
         os.path.join(ROOT, "tests", "cuda_host_emulation.h"), "-o", out,
         src],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return out


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/train_kernels.cu`` compiled as plain C++ (its DF_HOST_EMULATION
    mode, with tests/cuda_host_emulation.h standing in for the CUDA
    builtins): ``launch(threads, reverse, reverse_blocks=0)`` gives a
    launcher for ``ops.train_kernels._train_run_members`` that runs the
    kernel's body on CPU tensors, the blocks one after another and the
    threads of each phase one after another."""
    return _launcher(_compile_emulated(tmp_path_factory))


def _launcher(out):
    lib = ctypes.CDLL(out)
    lib.df_train_run_members_emulated.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 5
    lib.df_train_run_members_emulated.restype = ctypes.c_int

    def launch(threads, reverse, reverse_blocks=0):
        return lambda ptrs, iargs, fargs, k, _threads, shared_bytes: \
            lib.df_train_run_members_emulated(ptrs, iargs, fargs, k, threads,
                                              shared_bytes, reverse,
                                              reverse_blocks)

    return launch


def _emulate(case, launch, perms=None, tparams=None, mu=None, nu=None, **kw):
    full = dict(count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                track_best=False, w=None, w_valid=None, guard_nonfinite=False)
    full.update(kw)
    return TK._train_run_members(
        launch, case.plan, [tparams or case.tparams], case.masks, case.slots,
        case.cparams, [mu or case.zeros], [nu or case.zeros], *case.data,
        [case.perms if perms is None else perms], batchsize=case.bs,
        packed=case.packed, threads=None, **full)[0]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", ["reference", "joint", "nice", "actnorm",
                                     "permutation", "clamped", "deep",
                                     "nobias_tanh", "sigmoid",
                                     "unconditional"])
def test_cuda_source_emulated_equals_plain_version(emulated, variant, mode):
    case = Case(variant if variant != "unconditional" else "reference",
                n_cond=variant != "unconditional")
    kw = _mode_kwargs(case, mode)
    got = _emulate(case, emulated(96, 0), **kw)
    _assert_runs_close(got, case.plain(**kw))


def test_cuda_source_emulated_is_independent_of_thread_order(emulated):
    """Within a phase no thread reads what another writes: ascending and
    descending thread order, and another thread count, give the same bits."""
    case = Case("actnorm")
    kw = dict(track_best=True, guard_nonfinite=True, w=case.w,
              w_valid=case.wv)
    runs = [_emulate(case, emulated(nt, rev), **kw)
            for nt, rev in ((96, 0), (96, 1), (1024, 1), (32, 0))]
    for other in runs[1:]:
        _assert_runs_close(other, runs[0], atol=0.0)


@pytest.mark.parametrize("variant", ["reference", "joint", "actnorm",
                                     "nobias_tanh"])
def test_cuda_source_dense_handlers_on_ragged_row_groups(emulated, variant):
    """train_run's dense handlers take four rows an item: batches of 18
    rows (a last group of two), weighted, with track_best and the guard:
    1e-4 against the plain version, the same skips, the same bits in either
    thread order and at another thread count."""
    case = Case(variant, bs=18)
    kw = dict(_mode_kwargs(case, "weighted_best"), guard_nonfinite=True)
    got = _emulate(case, emulated(96, 0), **kw)
    _assert_runs_close(got, case.plain(**kw))
    _assert_runs_close(got, _emulate(case, emulated(160, 1), **kw), atol=0.0)


def _member_inputs(case, k_members, epochs=3):
    """K members of one plan: perturbed parameters, moments from a short
    plain run for all but the first, a batch order each."""
    rng = np.random.default_rng(11)
    tps, mus, nus, perms = [], [], [], []
    n = case.data[0].shape[0]
    for k in range(k_members):
        tps.append([p + (0.05 * k) * _t(rng.normal(size=p.shape))
                    for p in case.tparams])
        if k:
            warm = case.plain(perms=case.perms[:1], tparams=tps[-1])
            mus.append(warm[1])
            nus.append(warm[2])
        else:
            mus.append(case.zeros)
            nus.append(case.zeros)
        perms.append(np.stack([rng.permutation(n) for _ in range(epochs)]))
    return tps, mus, nus, perms


@pytest.mark.parametrize("mode", ["plain", "weighted_best", "guard_tagged"])
def test_cuda_source_emulated_members_equal_their_own_launches(emulated,
                                                                mode):
    """One launch of K = 3 blocks (the ensemble's member axis): member k
    equals its own one-member launch bit for bit, with the blocks run in
    either order, and the plain members at 1e-4."""
    case = Case("actnorm")
    kw = _mode_kwargs(case, mode)
    full = dict(count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                track_best=False, w=None, w_valid=None,
                guard_nonfinite=False)
    full.update(kw)
    tps, mus, nus, perms = _member_inputs(case, 3)
    singles = [_emulate(case, emulated(96, 0), perms=p, tparams=tp, mu=m,
                        nu=v, **kw)
               for tp, m, v, p in zip(tps, mus, nus, perms)]
    for reverse_blocks in (0, 1):
        got = TK._train_run_members(
            emulated(96, 0, reverse_blocks), case.plan, tps,
            case.masks, case.slots, case.cparams, mus, nus, *case.data,
            perms, batchsize=case.bs, packed=case.packed, threads=None,
            **full)
        assert len(got) == 3
        for one, member in zip(singles, got):
            _assert_runs_close(member, one, atol=0.0)
    plain = TK.run_fused_train_members(
        case.plan, tps, case.masks, case.slots, case.cparams, mus, nus,
        *case.data, perms, batchsize=case.bs, **kw)
    for member, want in zip(got, plain):
        _assert_runs_close(member, want)
    # the members differ: each trained its own parameters on its own order
    assert not torch.equal(got[0][3], got[1][3])


def test_member_launch_checks_its_arguments():
    case = Case("reference", epochs=2)
    tps, mus, nus, perms = _member_inputs(case, 2, epochs=2)
    with pytest.raises(ValueError, match="per member"):
        TK.run_fused_train_members(case.plan, tps, case.masks, case.slots,
                                   case.cparams, mus[:1], nus, *case.data,
                                   perms, batchsize=case.bs)
    with pytest.raises(ValueError, match="as many epochs"):
        TK._train_run_members(
            lambda *a: 0, case.plan, tps, case.masks, case.slots,
            case.cparams, mus, nus, *case.data, [perms[0], perms[1][:1]],
            batchsize=case.bs, count0=0, lr=1e-3, b1=0.9, b2=0.999,
            eps=1e-8, track_best=False, w=None, w_valid=None,
            guard_nonfinite=False, packed=case.packed, threads=None)


def test_kernel_source_is_hand_written():
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "train_kernels.cu")
    with open(src) as f:
        text = f.read()
    # the forward and backward phases lie in the header that this source and
    # the step kernel's include; the dense layers on this file's register
    # tiles
    assert '#include "flow_phases.cuh"' in text
    with open(os.path.join(os.path.dirname(src), "flow_phases.cuh")) as f:
        text += f.read()
    for symbol in ("df_train_run", "df_train_run_members", "member_args",
                   "train_run_kernel", "__global__", "f_dense4", "b_dense4", "b_dense", "adam_update",
                   "mask_and_check",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert symbol in text
    for library in ("cublas", "cudnn", "cutlass", "torch/extension.h"):
        assert library not in text.lower()


def test_cuda_source_emulated_guard_and_continuation(emulated):
    """NaN rows: the skipped batches, the applied-update count and the finite
    parameters equal the plain version's; two calls with carried state equal
    one call bit for bit."""
    _guard_and_continuation(emulated)


def _guard_and_continuation(emulated, **pack_kw):
    case = Case("reference", epochs=5, bs=16)
    if pack_kw:
        case.packed = TK.pack_train_plan(*case.head(), case.d, case.n,
                                         case.bs, **pack_kw)
    xt = case.data[0].clone()
    xt[[5, 40, 77], 1] = float("nan")
    case.data = (xt,) + case.data[1:]
    kw = dict(guard_nonfinite=True, track_best=True)
    launch = emulated(64, 0)
    one = _emulate(case, launch, **kw)
    want = case.plain(**kw)
    assert int(want[6].sum()) > 0 and one[6].tolist() == want[6].tolist()
    for i in (0, 1, 2, 5):
        for u, v in zip(one[i], want[i]):
            torch.testing.assert_close(u, v, rtol=0, atol=ATOL)
            assert bool(torch.isfinite(u).all())
    assert bool(torch.isnan(one[3]).all())      # NaN rows in the eval sets
    a = _emulate(case, launch, perms=case.perms[:2], **kw)
    n_batches = -(-xt.shape[0] // case.bs)
    b = _emulate(case, launch, perms=case.perms[2:], tparams=a[0], mu=a[1],
                 nu=a[2], count0=2 * n_batches - int(a[6].sum()), **kw)
    for i in (0, 1, 2):
        for u, v in zip(one[i], b[i]):
            assert torch.equal(u, v)
    assert one[6].tolist() == a[6].tolist() + b[6].tolist()


# -- train_run's lowering: paired nets, evaluation tiles -----------------------
#
# The resident layout pairs the s- and t-nets of a coupling (their layers in
# shared phases, each net with its own backward scratch) and evaluates on
# tiles of its own (the forward program lowered again, buffers reused). The
# CPU checks both against the plain version and the JAX package, through
# the lowered program and through the CUDA source under emulation, and the
# unpaired and small-tile layouts as well (the kernel's same code paths).

def _phases(words, n):
    body = np.asarray(words[TK._HEADER_WORDS:TK._HEADER_WORDS
                            + n * TK._INSTR_WORDS]).reshape(n, -1)
    groups = []
    for ins in body:
        if ins[TK._W_JOIN]:
            groups[-1].append(ins)
        else:
            groups.append([ins])
    return groups


@pytest.mark.parametrize("variant", ["reference", "joint", "nice", "deep",
                                     "actnorm"])
def test_paired_lowering_shares_phases(variant):
    """Paired: fewer phases than instructions, no two first-layer x blocks
    (both add into the x cotangent) in one phase, the phase's item starts
    the running sums of its instructions' items; unpaired: one instruction a
    phase, the step kernels' program words (14 and 15 zero)."""
    case = Case(variant, bs=64)
    pk = case.packed
    assert pk.paired and pk.staged and pk.eval_rows > pk.batchsize
    assert pk.grad_segments == 4
    words = pk.prog.tolist()
    fwd = _phases(words, pk.n_fwd)
    bwd = _phases(words[:TK._HEADER_WORDS]
                  + words[TK._HEADER_WORDS + pk.n_fwd * TK._INSTR_WORDS:],
                  pk.n_bwd)
    if variant not in ("joint", "nice"):     # nets to pair
        assert len(fwd) < pk.n_fwd and len(bwd) < pk.n_bwd
    for group in bwd:
        assert sum(1 for ins in group
                   if ins[0] == TK._B_DENSE and ins[8] == 1) <= 1
    for group in fwd + bwd:
        start = 0
        for ins in group:
            assert ins[TK._W_START] == start
            start += TK._items(list(ins), pk.batchsize, pk.d,
                               segs=pk.grad_segments)
    step, tile = TK.run_phase_names(pk)
    assert len(step) == len(fwd) + len(bwd) + 4
    assert len(tile) == len(_phases(pk.eval_prog.tolist(), pk.n_eval)) + 2
    flat = TK.pack_train_plan(*case.head(), case.d, case.n, 64,
                              paired=False)
    assert not flat.paired and flat.n_fwd == pk.n_fwd
    assert len(TK.run_phase_names(flat)[0]) == flat.n_fwd + flat.n_bwd + 4
    step_layout = TK.pack_train_plan(*case.head(), case.d, case.n, 64,
                                     state_in_shared=False)
    body = step_layout.prog[TK._HEADER_WORDS:].reshape(-1, TK._INSTR_WORDS)
    assert int(body[:, TK._W_START:].abs().sum()) == 0
    assert step_layout.eval_prog is None


@pytest.mark.parametrize("bs", [1, 7, 64])
@pytest.mark.parametrize("variant", ["reference", "joint", "nice", "deep",
                                     "actnorm", "nobias_tanh"])
def test_resident_layout_fits_where_state_and_one_batch_fit(
        monkeypatch, variant, bs):
    """The envelope does not narrow: with the block's limit set to the
    floats of the state (parameters, both moments, gradients, constants)
    plus the step kernel's layout of one batch, the packer still finds a
    layout within it (unpaired, one segment, the partial sums in the
    scalar area, the programs read from device memory)."""
    case = Case(variant, bs=bs)
    step = TK.pack_train_plan(*case.head(), case.d, case.n, bs,
                              state_in_shared=False)
    limit = 4 * (4 * step.n_params + step.flat_consts.numel()
                 + step.total_floats)
    monkeypatch.setattr(TK, "MAX_SHARED_BYTES", limit)
    packed = TK.pack_train_plan(*case.head(), case.d, case.n, bs)
    assert packed.shared_bytes <= limit
    assert (not packed.paired and packed.grad_segments == 1
            and not packed.staged)
    words = packed.prog.tolist()
    assert words[TK._H_PARTS] <= 2
    assert words[TK._H_PART] == packed.header["SCAL"] + 3


def test_cuda_source_emulated_on_the_smallest_layout(emulated, monkeypatch):
    """The CUDA source under emulation on that last layout, weighted, with
    track_best and the guard: 1e-4 against the plain version."""
    case = Case("reference", bs=64)
    step = TK.pack_train_plan(*case.head(), case.d, case.n, case.bs,
                              state_in_shared=False)
    monkeypatch.setattr(TK, "MAX_SHARED_BYTES", 4 * (
        4 * step.n_params + step.flat_consts.numel() + step.total_floats))
    case.packed = TK.pack_train_plan(*case.head(), case.d, case.n, case.bs)
    assert case.packed.prog.tolist()[TK._H_PARTS] == 2
    kw = dict(_mode_kwargs(case, "weighted_best"), guard_nonfinite=True)
    _assert_runs_close(_emulate(case, emulated(96, 1), **kw),
                       case.plain(**kw))


@pytest.mark.parametrize("layout", [(None, None), (7, 2), (64, 1)])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("variant", ["reference", "joint", "actnorm",
                                     "unconditional"])
def test_cuda_source_emulated_layouts_equal_plain_version(emulated, variant,
                                                          paired, layout):
    """The CUDA source under emulation on the paired and unpaired layouts,
    with evaluation tiles as large as fit, of 7 rows (a ragged last tile in
    both splits) and of 64, the gradients summed in 4, 2 and 1 segments of
    rows, weighted with track_best: 1e-4 against the plain version."""
    eval_rows, segs = layout
    case = Case(variant if variant != "unconditional" else "reference",
                n_cond=variant != "unconditional")
    case.packed = TK.pack_train_plan(*case.head(), case.d, case.n, case.bs,
                                     paired=paired, eval_rows=eval_rows,
                                     grad_segments=segs)
    assert case.packed.paired == paired
    assert case.packed.grad_segments == (segs or 4)
    kw = _mode_kwargs(case, "weighted_best")
    got = _emulate(case, emulated(96, 1), **kw)
    _assert_runs_close(got, case.plain(**kw))
    ref = TK.packed_train_reference(case.packed, case.tparams, case.zeros,
                                    case.zeros, *case.data, case.perms, **kw)
    _assert_runs_close(ref, case.plain(**kw))


def test_cuda_source_emulated_small_tiles_are_independent_of_thread_order(
        emulated):
    """Evaluation tiles of 7 rows, paired with the gradients in 4 segments
    and unpaired in 2: ascending and descending thread order and other
    thread counts give the same bits."""
    for paired, segs in ((True, 4), (False, 2)):
        case = Case("actnorm")
        case.packed = TK.pack_train_plan(*case.head(), case.d, case.n,
                                         case.bs, paired=paired, eval_rows=7,
                                         grad_segments=segs)
        kw = dict(track_best=True, guard_nonfinite=True, w=case.w,
                  w_valid=case.wv)
        runs = [_emulate(case, emulated(nt, rev), **kw)
                for nt, rev in ((96, 0), (96, 1), (512, 1), (32, 0))]
        for other in runs[1:]:
            _assert_runs_close(other, runs[0], atol=0.0)


def test_cuda_source_emulated_guard_and_continuation_small_tiles(emulated):
    """The guard and the continuation on the unpaired layout with evaluation
    tiles of 5 rows."""
    _guard_and_continuation(emulated, paired=False, eval_rows=5)


@pytest.mark.parametrize("variant", ["reference", "nice"])
def test_paired_lowering_equals_the_jax_kernel(emulated, variant):
    """The JAX package's whole-run kernel (Pallas, interpret mode) with the
    same folded tensors and batch order against the port's lowered program
    (packed_train_reference) and its CUDA source under emulation, on the
    paired layout with its evaluation tiles: parameters, moments and both
    histories within 1e-4 after 3 epochs."""
    from densityflows_tpu.models.fused_train import (
        chain_train_fold as jax_fold)
    from densityflows_tpu.ops.pallas_train import (
        run_fused_train as jax_run)

    from _torch_parity import jax_epoch_perms

    case = Case(variant)
    (plan, tcounts, tparams, masks, slots, cparams, _f, unfold) = \
        jax_fold(case.jchain)
    xt, tht, xv, thv = (np.asarray(a) if a is not None else None
                        for a in case.data)
    key = jax.random.key(11)
    case.perms = jax_epoch_perms(key, 3, xt.shape[0])
    zeros = [np.zeros(np.shape(p), np.float32) for p in tparams]
    want = jax_run(plan, tcounts, list(tparams), list(masks), slots,
                   list(cparams), zeros, zeros, xt, tht, xv, thv, key,
                   epochs=3, batchsize=case.bs, interpret=True)
    want_chain = unfold(list(want[0]))
    got_ref = TK.packed_train_reference(case.packed, case.tparams,
                                        case.zeros, case.zeros, *case.data,
                                        case.perms)
    got_emu = _emulate(case, emulated(64, 0))
    for got in (got_ref, got_emu):
        # the packages fold the nets differently: compare the model's leaves
        chain = copy.deepcopy(case.chain)
        FT.load_leaves_(chain, case.unfold(got[0]))
        assert_leaves_close(want_chain, chain, ATOL)
        for i in (3, 4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       rtol=0, atol=ATOL)
