"""The port's streaming whole-run trainer (``train_fused`` stream mode →
``ops/stream_kernels.py``) on the CPU against the JAX package, and the CUDA
source ``csrc/stream_kernels.cu`` itself under host emulation.

On the CPU the wrapper runs the kernel's plain version
(``fused_train_stream_plain``). The JAX side runs its streaming Pallas
kernel as its own tests run it: ``models.fused_train._check_budget`` is
monkeypatched to raise, so that ``train_fused`` takes the stream mode, and
the kernel runs in interpret mode. The port's ``_check_budget`` is forced
the same way, and the JAX package's batch order is injected through
``_epoch_perms``. The CUDA source is compiled with the host compiler in its
``-DDF_HOST_EMULATION`` mode, each grid phase run over all blocks in either
order, and held against ``fused_train_stream_plain``.

Tolerances, as stated in each test: ``TRAIN_ATOL`` = 1e-4 absolute for a
few epochs of Adam on two implementations (the JAX suite's own bar, float
accumulation order); 1e-5 (scaled) for one evaluation; bit equality where
the same code runs the same sums in the same order.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import fused_train as JFT
from densityflows_tpu.ops import pallas_train_stream as JST
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops import step_kernels as SK
from densityflows_tpu_torch.ops import stream_kernels as SKM
from densityflows_tpu_torch.ops import train_kernels as TK

from _torch_parity import (
    TRAIN_ATOL, TRAIN_CHAINS as CHAINS, assert_leaves_close,
    assert_opt_state_close, cond_data, jax_epoch_perms, randomize, to_torch,
    torch_flow)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _force_stream(monkeypatch):
    """Both packages' resident envelopes fail, so ``train_fused`` takes the
    stream mode at test-sized configs."""
    def j_raise(*a, **k):
        raise JFT.UnsupportedFusedTrain("probe: force stream")

    def t_raise(packed):
        raise FT.UnsupportedFusedTrain("probe: force stream")

    monkeypatch.setattr(JFT, "_check_budget", j_raise)
    monkeypatch.setattr(FT, "_check_budget", t_raise)


@pytest.fixture(scope="module")
def cond():
    return cond_data()


def _clamped_chain(data, x):
    return df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.coupling_layer(data, [2, 3, 4], key=jax.random.key(1),
                          joint_conditioner=True, hidden_dim_s=8,
                          hidden_dim_t=8, max_log_scale=3.0),
        df.normalization_layer(x, -1.0, 1.0))


def _one_coupling(data, x):
    return df.flow_chain(
        df.coupling_layer(data, [0, 1, 2], key=jax.random.key(0),
                          hidden_dim_s=8, hidden_dim_t=8),
        df.normalization_layer(x, -1.0, 1.0))


# -- the stream mode against the JAX package ---------------------------------------

def test_stream_kernel_matches_jnp(cond, monkeypatch):
    """Weighted, with a joint clamped layer, 5 epochs of batch 32: the port's
    stream mode against the JAX jnp program and the JAX streaming kernel
    (interpret mode) — histories, parameters, Adam count and moments at
    TRAIN_ATOL."""
    _force_stream(monkeypatch)
    jd, td, x = cond
    w = np.random.default_rng(7).uniform(0.2, 3.0, size=137).astype(
        np.float32)
    f_j, f_s = df.Flow(_clamped_chain(jd, x), jd), df.Flow(
        _clamped_chain(jd, x), jd)
    f_t = torch_flow(f_j, td)
    kw = dict(epochs=5, batchsize=32, verbose=False, weights=w)
    os_j = df.train(f_j, jd, key=jax.random.key(5), fused_kernel=False, **kw)
    os_s = JFT.train_fused(f_s, jd, key=jax.random.key(5), **kw)
    assert f_s.fused_kernel_mode == "stream"
    perms = jax_epoch_perms(jax.random.key(5), 5, len(jd.partition.training))
    os_t = dt.train(f_t, td, fused_kernel=True, _epoch_perms=perms, **kw)
    assert f_t.trained_path == "fused" and f_t.fused_kernel_mode == "stream"
    for ref, s_ref in ((f_j, os_j), (f_s, os_s)):
        np.testing.assert_allclose(f_t.train_loss, ref.train_loss,
                                   atol=TRAIN_ATOL)
        np.testing.assert_allclose(f_t.valid_loss, ref.valid_loss,
                                   atol=TRAIN_ATOL)
        assert_leaves_close(ref.model, f_t.model, TRAIN_ATOL)
        assert_opt_state_close(s_ref, f_t.model, os_t, TRAIN_ATOL)


def test_stream_kernel_guard_and_chunks(monkeypatch):
    """NaN-poisoned rows with ``skip_nonfinite`` and the device budget shrunk
    to two epochs per chunk (three launches' worth of chunks): skip counts,
    the Adam count carried across chunks and the parameters against the JAX
    streaming kernel (chunked the same way) and the jnp program at
    TRAIN_ATOL."""
    import bench

    _force_stream(monkeypatch)
    jd, build = bench.guard_parity_case(jax, df)
    td = dt.DataArrays.make(np.asarray(jd.x), rng=0)
    f_j, f_s = build(), build()
    f_t = torch_flow(f_j, td)
    n = len(jd.partition.training)
    nb = -(-n // 16)
    kw = dict(epochs=6, batchsize=16, verbose=False, skip_nonfinite=True)
    os_j = df.train(f_j, jd, key=jax.random.key(3), fused_kernel=False, **kw)
    j_tparams = JFT.chain_train_fold(f_s.model)[2]
    j_snap = sum(int(np.prod(p.shape)) for p in j_tparams) * 4
    monkeypatch.setattr(JFT, "_HBM_SLAB_BUDGET", 2 * (nb * 16 * 4 * 4
                                                      + j_snap))
    os_s = JFT.train_fused(f_s, jd, key=jax.random.key(3), **kw)

    n_params = sum(p.numel() for p in FT.chain_train_fold(f_t.model)[2])
    monkeypatch.setattr(FT, "_STREAM_DEVICE_BUDGET",
                        2 * 4 * (nb * 16 + n_params))
    calls = []
    real = SKM.run_fused_train_stream

    def spy(*a, **k):
        calls.append(len(a[9]))
        return real(*a, **k)

    spy.tc_launches = 0     # the wrapper's count; the CPU launches neither
    monkeypatch.setattr(SKM, "run_fused_train_stream", spy)
    os_t = FT.train_fused(f_t, td, _epoch_perms=jax_epoch_perms(
        jax.random.key(3), 6, n), **kw)
    assert f_t.fused_kernel_mode == "stream" and calls == [2, 2, 2]
    assert f_t.skipped_updates == f_s.skipped_updates == f_j.skipped_updates
    assert sum(f_t.skipped_updates) > 0
    assert os_t.count == int(os_s[0].count) == int(os_j[0].count) == \
        6 * nb - sum(f_t.skipped_updates)
    for ref in (f_j, f_s):
        assert_leaves_close(ref.model, f_t.model, TRAIN_ATOL)
    for leaf in trainable_leaves(f_t.model):
        assert bool(torch.isfinite(leaf).all())


def test_stream_kernel_track_best(cond, monkeypatch):
    """``track_best`` across chunk boundaries (6 epochs, chunks of 4 and 2
    balanced to 3 and 3): the same argmin epoch as the JAX streaming kernel
    and the jnp program, the best model equal to the JAX streaming kernel's
    at TRAIN_ATOL, and evaluating it reproduces the minimum (1e-5)."""
    _force_stream(monkeypatch)
    jd, td, x = cond
    f_j, f_s = df.Flow(_one_coupling(jd, x), jd), df.Flow(
        _one_coupling(jd, x), jd)
    f_t = torch_flow(f_j, td)
    kw = dict(epochs=6, batchsize=32, verbose=False)
    _, best_j = df.train(f_j, jd, key=jax.random.key(4), _track_best=True,
                         fused_kernel=False, **kw)
    _, best_s = JFT.train_fused(f_s, jd, key=jax.random.key(4),
                                track_best=True, **kw)
    n = len(jd.partition.training)
    n_params = sum(p.numel() for p in FT.chain_train_fold(f_t.model)[2])
    monkeypatch.setattr(FT, "_STREAM_DEVICE_BUDGET",
                        4 * 4 * (-(-n // 32) * 32 + n_params))
    _, best_t = FT.train_fused(f_t, td, track_best=True,
                               _epoch_perms=jax_epoch_perms(
                                   jax.random.key(4), 6, n), **kw)
    assert np.argmin(f_t.valid_loss) == np.argmin(f_s.valid_loss) == \
        np.argmin(f_j.valid_loss)
    assert_leaves_close(best_s, best_t, TRAIN_ATOL, "best")
    np.testing.assert_allclose(
        dt.evaluate(dt.Flow(best_t, td, device="cpu"), td, "validation"),
        min(f_t.valid_loss), atol=1e-5)


@pytest.mark.parametrize("nan_epoch", [0, 3, 5])
def test_track_best_with_a_nan_validation_epoch(cond, monkeypatch,
                                                nan_epoch):
    """A NaN validation NLL at one epoch (injected into both packages'
    snapshot evaluations), 6 epochs in chunks of 2: per chunk ``np.argmin``
    picks the NaN where the chunk holds one, only the first chunk seeds and a
    NaN never wins later — so a NaN in the first chunk keeps that chunk's NaN
    epoch for good, a NaN later leaves the other chunks' minimum. The JAX
    stream mode and the port pick the same epoch; the best models agree at
    TRAIN_ATOL. (The resident kernel's rule differs: a NaN stops every later
    update.)"""
    _force_stream(monkeypatch)
    jd, td, x = cond
    f_s = df.Flow(_one_coupling(jd, x), jd)
    f_t = torch_flow(f_s, td)
    n = len(jd.partition.training)
    nb = -(-n // 32)

    def poisoned(real, pick):
        seen = []

        def fn(*a, **k):
            out = real(*a, **k)
            seen.append(None)
            if len(seen) % 2 == 0:            # the validation call
                chunk = len(seen) // 2 - 1
                local = nan_epoch - 2 * chunk
                if 0 <= local < len(out):
                    out = pick(out, local)
            return out
        return fn

    def j_pick(out, i):
        return out.at[i].set(np.nan)

    def t_pick(out, i):
        out = out.clone()
        out[i] = float("nan")
        return out

    j_tparams = JFT.chain_train_fold(f_s.model)[2]
    j_snap = sum(int(np.prod(p.shape)) for p in j_tparams) * 4
    monkeypatch.setattr(JFT, "_HBM_SLAB_BUDGET",
                        2 * (nb * 32 * 6 * 4 + j_snap))
    monkeypatch.setattr(JST, "eval_snapshots",
                        poisoned(JST.eval_snapshots, j_pick))
    n_params = sum(p.numel() for p in FT.chain_train_fold(f_t.model)[2])
    monkeypatch.setattr(FT, "_STREAM_DEVICE_BUDGET",
                        2 * 4 * (nb * 32 + n_params))
    monkeypatch.setattr(SKM, "eval_snapshots",
                        poisoned(SKM.eval_snapshots, t_pick))
    kw = dict(epochs=6, batchsize=32, verbose=False, track_best=True)
    _, best_s = JFT.train_fused(f_s, jd, key=jax.random.key(6), **kw)
    _, best_t = FT.train_fused(f_t, td, _epoch_perms=jax_epoch_perms(
        jax.random.key(6), 6, n), **kw)
    vl = np.asarray(f_t.valid_loss)
    assert np.isnan(vl[nan_epoch]) and np.isnan(f_s.valid_loss[nan_epoch])
    assert np.isnan(vl).sum() == 1
    # the rule, spelled out over the port's history
    want, best_vl = None, np.inf
    for c in range(3):
        arg = 2 * c + int(np.argmin(vl[2 * c:2 * c + 2]))
        if want is None or vl[arg] < best_vl:
            want, best_vl = arg, vl[arg]
    assert (want == nan_epoch) == (nan_epoch < 2)
    if want != nan_epoch:
        # the kept snapshot is that epoch's: evaluating it gives its entry
        ev = dt.evaluate(dt.Flow(best_t, td, device="cpu"), td, "validation")
        np.testing.assert_allclose(ev, vl[want], atol=1e-5)
    assert_leaves_close(best_s, best_t, TRAIN_ATOL, "best")


# -- eval_snapshots ---------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_eval_snapshots_equals_jax(cond, weighted):
    """Three snapshots (three randomized models), row chunks of 16 over 123
    rows (a ragged last chunk), with and without weights: against the JAX
    ``eval_snapshots`` at 1e-5 (scaled by the NLL)."""
    jd, td, x = cond
    chains = [randomize(CHAINS["joint"](jd, x), s) for s in (1, 2, 3)]
    j_folds = [JFT.chain_train_fold(c) for c in chains]
    t_folds = [FT.chain_train_fold(to_torch(c)) for c in chains]
    rng = np.random.default_rng(3)
    xs = (rng.normal(size=(123, 5)) * 0.7).astype(np.float32)
    th = rng.uniform(size=(123, 1)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=123).astype(np.float32) if weighted \
        else None
    j_snaps = [jax.numpy.stack([f[2][k] for f in j_folds])
               for k in range(len(j_folds[0][2]))]
    want = np.asarray(JST.eval_snapshots(
        j_snaps, list(j_folds[0][5]), jax.numpy.asarray(xs),
        jax.numpy.asarray(th), None if w is None else jax.numpy.asarray(w),
        plan=j_folds[0][0], tcounts=tuple(j_folds[0][1]), row_chunk=16))
    t_snaps = [torch.stack([f[2][k] for f in t_folds])
               for k in range(len(t_folds[0][2]))]
    got = SKM.eval_snapshots(
        t_snaps, t_folds[0][5], torch.as_tensor(xs), torch.as_tensor(th),
        None if w is None else torch.as_tensor(w), plan=t_folds[0][0],
        row_chunk=16)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    # one chunk of everything gives the same
    one = SKM.eval_snapshots(
        t_snaps, t_folds[0][5], torch.as_tensor(xs), torch.as_tensor(th),
        None if w is None else torch.as_tensor(w), plan=t_folds[0][0])
    np.testing.assert_allclose(one.numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))


# -- routing and the envelope --------------------------------------------------------

class _FakeCuda:
    type = "cuda"


def _train_module():
    return sys.modules["densityflows_tpu_torch.train"]


def test_auto_routing_reaches_the_stream_mode(cond, monkeypatch):
    """``train(fused_kernel="auto")`` on a flow that claims a CUDA device
    (there is no card here: the call into ``train_fused`` puts the flow back
    on the CPU) whose resident envelope fails: the stream mode runs with no
    decline and no warning, ``trained_path`` is ``"fused"``. A chain outside
    both envelopes (an ``"elu"`` conditioner, outside ``TRAIN_ACTS``) is
    declined by name with a RuntimeWarning, and the plain program trains
    it."""
    import warnings

    _force_stream(monkeypatch)
    tm = _train_module()
    jd, td, x = cond
    real = FT.train_fused
    fake = _FakeCuda()

    def on_cpu(flow, data, **k):
        flow.device = torch.device("cpu")
        try:
            return real(flow, data, **k)
        finally:
            flow.device = fake

    monkeypatch.setattr(tm, "train_fused", on_cpu)
    monkeypatch.setattr(sys.modules["densityflows_tpu_torch.data"],
                        "_as_tensor", lambda a, device: torch.as_tensor(a))
    flow = torch_flow(df.Flow(CHAINS["reference"](jd, x), jd), td)
    flow.device = fake
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        dt.train(flow, td, epochs=2, batchsize=32, verbose=False,
                 generator=torch.Generator().manual_seed(0))
    assert flow.trained_path == "fused" and flow.fused_kernel_mode == "stream"
    assert flow.fused_decline_reason is None and len(flow.valid_loss) == 2

    g = torch.Generator().manual_seed(0)
    elu = dt.Flow(dt.flow_chain(
        dt.coupling_layer(td, [0, 1, 2], activation_s="elu",
                          activation_t="elu", generator=g, device="cpu"),
        dt.normalization_layer(x, -1.0, 1.0, device="cpu")), td,
        device="cpu")
    elu.device = fake
    with pytest.warns(RuntimeWarning, match="activation 'elu'"):
        dt.train(elu, td, epochs=1, batchsize=32, verbose=False,
                 generator=torch.Generator().manual_seed(0))
    assert elu.trained_path == "torch" and len(elu.valid_loss) == 1
    assert "activation 'elu'" in elu.fused_decline_reason


def test_outside_both_envelopes_raises_with_both_reasons(cond, monkeypatch):
    """With one row's caches over the (lowered) limit, the stream mode
    declines too: ``UnsupportedFusedTrain`` names the resident kernel's and
    the streaming kernel's bytes, and nothing ran."""
    jd, td, x = cond
    flow = torch_flow(df.Flow(CHAINS["reference"](jd, x), jd), td)
    plan, tc, tparams, masks, slots, cparams, _f, _u = \
        FT.chain_train_fold(flow.model)
    sp = SK.StepPlan(plan, tparams, masks, slots, cparams, 5, 1, tc)
    assert SKM.stream_reason(sp) is None
    assert SKM.stream_shared_bytes(sp, 64) == sp.shared_bytes(8, True)
    monkeypatch.setattr(FT, "MAX_SHARED_BYTES", 1000)
    monkeypatch.setattr(SKM, "MAX_SHARED_BYTES", sp.shared_bytes(1) - 28)
    with pytest.raises(dt.UnsupportedFusedTrain) as err:
        dt.train(flow, td, epochs=1, verbose=False, fused_kernel=True)
    msg = str(err.value)
    assert "resident whole-run kernel" in msg and "train_stream needs" in msg
    assert f"{sp.shared_bytes(1)} bytes" in msg
    assert flow.train_loss == []


def test_launch_shape_tiles_grid_and_co_residency(cond, monkeypatch):
    """The tile body (the design of a plan this narrow): the row tile and
    threads are the step kernel's (at most 512 threads);
    the parameters are staged where they fit beside the tile, and the shared
    bytes count them; the grid one block per tile, capped at the blocks that
    can be resident at once; an explicit grid past that cap, or past the
    tiles, is refused with a message, as is staging where it does not fit;
    narrower tiles where a tile's caches do not fit."""
    jd, td, x = cond
    chain = to_torch(CHAINS["reference"](jd, x))
    plan, tc, tparams, masks, slots, cparams, _f, _u = \
        FT.chain_train_fold(chain)
    sp = SK.StepPlan(plan, tparams, masks, slots, cparams, 5, 1, tc)
    assert SKM.launch_shape(sp, 1024) == (8, 128, sp.shared_bytes(8, True),
                                          128, True, False)
    assert SKM.launch_shape(sp, 1024, stage=False) == (
        8, 128, sp.shared_bytes(8), 128, False, False)
    assert SKM.launch_shape(sp, 1024, co_resident=100)[3] == 100
    assert SKM.launch_shape(sp, 1024, co_resident=264)[3] == 128
    assert SKM.launch_shape(sp, 60)[3] == 8           # a ragged last tile
    assert SKM.launch_shape(sp, 1024, n_blocks=3)[3] == 3
    with pytest.raises(ValueError, match="can be resident at once"):
        SKM.launch_shape(sp, 1024, co_resident=100, n_blocks=101)
    with pytest.raises(ValueError, match="cooperative launch"):
        SKM.launch_shape(sp, 1024, co_resident=0)
    with pytest.raises(ValueError, match="every block needs a tile"):
        SKM.launch_shape(sp, 64, n_blocks=9)
    monkeypatch.setattr(SKM, "MAX_SHARED_BYTES", sp.shared_bytes(8) + 200)
    assert SKM.launch_shape(sp, 1024)[4] is False     # no room to stage
    with pytest.raises(ValueError, match="to stage the parameters"):
        SKM.launch_shape(sp, 1024, stage=True)
    monkeypatch.setattr(SKM, "MAX_SHARED_BYTES", sp.shared_bytes(4) + 200)
    # 4-row tiles cut the batch into 256: the rule takes the tensor-core
    # design, and the tile body's own shape is held with the rule off
    assert SKM.launch_shape(sp, 1024).tc
    monkeypatch.setattr(SKM, "uses_tc", lambda sp, batchsize: False)
    assert SKM.launch_shape(sp, 1024)[0] == 4
    with pytest.raises(ValueError, match="unsupported device"):
        SKM.run_fused_train_stream(
            plan, tparams, masks, slots, cparams, tparams, tparams,
            torch.zeros(4, 5, device="meta"), None, np.zeros((1, 4), int),
            batchsize=2)


# -- the CUDA source under host emulation ------------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/stream_kernels.cu`` compiled as plain C++ (its DF_HOST_EMULATION
    mode, tests/cuda_host_emulation.h standing in for the CUDA builtins and
    the grid): ``launch(threads, reverse)`` gives a launcher for
    ``ops.stream_kernels._train_stream``. ``reverse`` bit 0: the threads of a
    phase last first; bit 1: the blocks of a grid phase last first."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = str(tmp_path_factory.mktemp("emu") / "libstream_emulated.so")
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "stream_kernels.cu")
    # -ffp-contract=off: fmaf() stays the only fused multiply-add, as written
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-DDF_HOST_EMULATION", "-include",
         os.path.join(ROOT, "tests", "cuda_host_emulation.h"), "-o", out,
         src],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(out)
    lib.df_train_stream_emulated.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.df_train_stream_emulated.restype = ctypes.c_int
    # the wrapper's mirror of the tensor-core design's shared memory
    assert 4 * lib.df_train_stream_tc_shared_floats() == SKM.TC_SHARED_BYTES

    def launch(threads, reverse):
        return lambda ptrs, iargs, fargs, _threads, shared, n_blocks: \
            lib.df_train_stream_emulated(ptrs, iargs, fargs, threads, shared,
                                         n_blocks, reverse)

    return launch


class StreamCase:
    """A folded chain of ``TRAIN_CHAINS``, its normalized training split (123
    rows: batches of 32 leave a ragged last one), a batch order and
    importance weights, one of whose row tiles (rows 8..15 of the first
    batch) is fully masked."""

    def __init__(self, variant, epochs=3, seed=5):
        jd, td, x = cond_data()
        self.chain = to_torch(randomize(CHAINS[variant](jd, x), seed))
        flow = dt.Flow(self.chain, td, device="cpu")
        (self.plan, tc, self.tparams, self.masks, self.slots, self.cparams,
         _f, self.unfold) = FT.chain_train_fold(self.chain)
        xt, tht = td.normalized_training_data(flow.metadata)
        self.x = torch.as_tensor(np.ascontiguousarray(xt, np.float32))
        self.th = torch.as_tensor(np.ascontiguousarray(tht, np.float32))
        self.sp = SK.StepPlan(self.plan, self.tparams, self.masks, self.slots,
                              self.cparams, 5, 1, tc)
        rng = np.random.default_rng(seed)
        n = self.x.shape[0]
        self.perms = np.stack([rng.permutation(n) for _ in range(epochs)])
        w = rng.uniform(0.3, 2.0, size=n).astype(np.float32)
        w[self.perms[0, 8:16]] = 0.0
        self.w = torch.as_tensor(w)
        self.zeros = [torch.zeros_like(p) for p in self.tparams]

    def run(self, launch=None, n_blocks=None, perms=None, state=None,
            stage=None, **kw):
        tparams, mu, nu = state or (self.tparams, self.zeros, self.zeros)
        perms = self.perms if perms is None else perms
        args = (tparams, mu, nu, self.x, self.th, perms)
        kw = dict(dict(batchsize=32, w=self.w, with_losses=True), **kw)
        if launch is None:
            return SKM.fused_train_stream_plain(
                self.plan, tparams, self.masks, self.slots, self.cparams, mu,
                nu, self.x, self.th, perms, **kw)
        full = dict(count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                    guard_nonfinite=False)
        full.update(kw)
        return SKM._train_stream(
            launch, self.sp, *args, shape=SKM.launch_shape(
                self.sp, full["batchsize"], n_blocks=n_blocks, stage=stage),
            **full)


def _assert_runs(got, want, atol):
    """params, mu, nu, snapshots, skips, per-step losses; atol 0 = bits."""
    for i in (0, 1, 2, 3):
        for a, b in zip(got[i], want[i]):
            if atol == 0:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=atol)
    assert (got[4] is None) == (want[4] is None)
    if got[4] is not None:
        assert got[4].tolist() == want[4].tolist()
    # a poisoned batch's loss is NaN on both sides
    assert torch.equal(torch.isnan(got[5]), torch.isnan(want[5]))
    if atol == 0:
        assert torch.equal(got[5].nan_to_num(), want[5].nan_to_num())
    else:
        torch.testing.assert_close(got[5], want[5], rtol=0, atol=atol,
                                   equal_nan=True)


@pytest.mark.parametrize("variant", ["reference", "joint", "actnorm",
                                     "clamped", "nice", "nobias_tanh"])
def test_cuda_source_emulated_equals_plain_version(emulated, variant):
    """3 epochs of batch 32 over 123 rows (a ragged last batch), weighted,
    one fully masked tile: parameters, moments, snapshots and per-step
    losses against ``fused_train_stream_plain`` at TRAIN_ATOL (the same f32
    arithmetic summed in another order, through Adam)."""
    case = StreamCase(variant)
    _assert_runs(case.run(emulated(96, 0)), case.run(), TRAIN_ATOL)


def test_cuda_source_emulated_is_independent_of_thread_and_block_order(
        emulated):
    """Threads and blocks of every phase in either order and another thread
    count give the same bits (no race inside a block's phase, no block
    depends on another's order within a grid phase, nothing is carried in
    shared memory across a grid barrier). Fewer blocks than tiles agree with
    the plain version at TRAIN_ATOL, and each grid alike in both orders."""
    case = StreamCase("actnorm")
    runs = [case.run(emulated(nt, rev))
            for nt, rev in ((96, 0), (96, 1), (96, 2), (64, 3), (1024, 0))]
    for other in runs[1:]:
        _assert_runs(other, runs[0], 0)
    want = case.run()
    for n_blocks in (1, 3):
        a = case.run(emulated(96, 0), n_blocks=n_blocks)
        b = case.run(emulated(32, 3), n_blocks=n_blocks)
        _assert_runs(b, a, 0)
        _assert_runs(a, want, TRAIN_ATOL)


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("n_blocks", [None, 3])
def test_cuda_source_emulated_parameters_in_shared_or_device_memory(
        emulated, guard, n_blocks):
    """The tile body with the parameters, constants and program staged in
    shared memory (the constants and program kept across the grid barriers
    of the launch, the parameters staged anew every step) and with all three
    read from device memory: the same bits, threads and blocks in either
    order and at another thread count, with the guard's three phases a step
    or the two without it."""
    case = StreamCase("nobias_tanh")
    runs = {(stage, nt, rev): case.run(emulated(nt, rev), n_blocks=n_blocks,
                                       stage=stage, guard_nonfinite=guard)
            for stage in (True, False)
            for nt, rev in ((96, 0), (32, 3), (128, 2))}
    want = runs[True, 96, 0]
    for other in runs.values():
        _assert_runs(other, want, 0)
    _assert_runs(want, case.run(guard_nonfinite=guard), TRAIN_ATOL)


def _lane_denominators(idx, n_rows, batchsize, w):
    """The batch denominators as the kernel summed them before they came in
    from the wrapper: per batch, lane l sums positions l, l + 32, ... in
    order from 0 in float32, then the lanes in order, then fmaxf(s, 1e-12)
    (1e-12 for a NaN sum)."""
    epochs, n_pad = idx.shape
    out = []
    for e in range(epochs):
        for b in range(n_pad // batchsize):
            lanes = []
            for lane in range(32):
                s = np.float32(0)
                for q in range(lane, batchsize, 32):
                    pos = b * batchsize + q
                    mk = np.float32(1 if pos < n_rows else 0)
                    if w is not None:
                        mk = np.float32(mk * w[idx[e, pos]])
                    s = np.float32(s + mk)
                lanes.append(s)
            s = np.float32(0)
            for v in lanes:
                s = np.float32(s + v)
            out.append(s if s >= np.float32(1e-12) else np.float32(1e-12))
    return np.array(out, np.float32)


@pytest.mark.parametrize("batchsize,weighted", [
    (32, False), (50, True), (1024, True), (1000, False)])
def test_batch_denominators_equal_the_kernel_lane_order(batchsize,
                                                        weighted):
    """The denominators the wrapper computes before the launch equal, bit
    for bit, the 32-lane sums the kernel took in every block: ragged last
    batches (pad positions masked), importance weights of mixed scale, a
    row of weight 0, and a NaN weight whose batches clamp to 1e-12."""
    rng = np.random.default_rng(batchsize)
    n_rows, epochs = 2 * batchsize + 7, 2
    perms = np.stack([rng.permutation(n_rows) for _ in range(epochs)])
    idx = TK.pad_epoch_perms(perms, n_rows, batchsize)
    w = None
    if weighted:
        w = (rng.uniform(0.0, 3.0, size=n_rows)
             * 10.0 ** rng.integers(-3, 4, size=n_rows)).astype(np.float32)
        w[perms[0, 3]] = 0.0
        w[perms[1, 5]] = np.nan
    got = SKM.batch_denominators(
        torch.as_tensor(idx), n_rows, batchsize,
        None if w is None else torch.as_tensor(w)).numpy()
    want = _lane_denominators(idx, n_rows, batchsize, w)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    if weighted:
        assert got[(epochs - 1) * (len(got) // epochs)] == np.float32(1e-12)


def test_cuda_source_emulated_guard_skips_and_chunks(emulated):
    """NaN rows poison the batches that gather them: with the guard the
    kernel skips the same steps as the plain version, keeps the parameters
    finite and counts the skips per epoch; without it the NaN reaches the
    parameters on both sides. Two chunked calls with the state and the
    count carried equal one call, bit for bit."""
    case = StreamCase("reference", epochs=4)
    x = case.x.clone()
    x[[5, 40, 77], 1] = float("nan")
    case.x = x
    got = case.run(emulated(96, 0), guard_nonfinite=True)
    want = case.run(guard_nonfinite=True)
    assert got[4].tolist() == want[4].tolist() and int(got[4].sum()) > 0
    _assert_runs(got, want, TRAIN_ATOL)
    for p in got[0] + got[1] + got[2]:
        assert bool(torch.isfinite(p).all())
    bare = case.run(emulated(96, 0))
    assert not all(bool(torch.isfinite(p).all()) for p in bare[0])

    n_batches = -(-case.x.shape[0] // 32)
    launch = emulated(96, 0)
    a = case.run(launch, perms=case.perms[:2], guard_nonfinite=True)
    b = case.run(launch, perms=case.perms[2:], state=a[:3],
                 count0=2 * n_batches - int(a[4].sum()),
                 guard_nonfinite=True)
    for i in (0, 1, 2):
        for u, v in zip(got[i], b[i]):
            assert torch.equal(u, v)
    for k in range(len(got[3])):
        assert torch.equal(got[3][k], torch.cat([a[3][k], b[3][k]]))
    assert got[4].tolist() == a[4].tolist() + b[4].tolist()


@pytest.mark.parametrize("stage", [True, False])
def test_cuda_source_emulated_matches_the_jax_stream_kernel(
        cond, monkeypatch, emulated, stage):
    """``train()`` in the stream mode with the CUDA source itself in place of
    the wrapper's launch (the parameters staged in shared memory, or read
    from device memory), against the JAX streaming kernel in interpret mode:
    weighted, a joint clamped layer, 3 epochs of batch 32; histories,
    parameters and Adam moments at TRAIN_ATOL, as the plain version is
    held."""
    _force_stream(monkeypatch)
    jd, td, x = cond
    w = np.random.default_rng(7).uniform(0.2, 3.0, size=137).astype(
        np.float32)
    f_s = df.Flow(_clamped_chain(jd, x), jd)
    f_t = torch_flow(df.Flow(_clamped_chain(jd, x), jd), td)
    kw = dict(epochs=3, batchsize=32, verbose=False, weights=w)
    os_s = JFT.train_fused(f_s, jd, key=jax.random.key(5), **kw)
    assert f_s.fused_kernel_mode == "stream"
    launch, calls = emulated(64, 2), []

    def run(plan, tparams, masks, mask_slots, cparams, mu, nu, x, theta,
            epoch_perms, *, batchsize, step_plan=None, n_blocks=None,
            clocks=None, **kw):
        sp = step_plan or SK.StepPlan(plan, list(tparams), masks, mask_slots,
                                      cparams, x.shape[-1],
                                      theta.shape[-1] if theta is not None
                                      else 0)
        calls.append(len(epoch_perms))
        kw = dict(dict(count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, w=None,
                       guard_nonfinite=False, with_losses=False), **kw)
        shape = SKM.launch_shape(sp, batchsize, stage=stage)
        run.tc_launches += int(shape.tc)   # as the wrapper counts
        return SKM._train_stream(
            launch, sp, list(tparams), list(mu), list(nu), x, theta,
            epoch_perms, batchsize=batchsize, shape=shape, **kw)

    run.tc_launches = 0
    monkeypatch.setattr(SKM, "run_fused_train_stream", run)
    perms = jax_epoch_perms(jax.random.key(5), 3, len(jd.partition.training))
    os_t = dt.train(f_t, td, fused_kernel=True, _epoch_perms=perms, **kw)
    assert calls and sum(calls) == 3
    assert f_t.trained_path == "fused" and f_t.fused_kernel_mode == "stream"
    np.testing.assert_allclose(f_t.train_loss, f_s.train_loss,
                               atol=TRAIN_ATOL)
    np.testing.assert_allclose(f_t.valid_loss, f_s.valid_loss,
                               atol=TRAIN_ATOL)
    assert_leaves_close(f_s.model, f_t.model, TRAIN_ATOL)
    assert_opt_state_close(os_s, f_t.model, os_t, TRAIN_ATOL)


# -- the tensor-core design under host emulation ---------------------------------------
#
# The tensor-core design (csrc/stream_tc.cuh) is taken where the tile body
# would cut a batch into more than TC_MIN_TILES tiles; the tests' chains and
# batches are smaller, so ``_tc`` sends every plan it can run there. On the
# host its products are the stand-in that splits the operands as the card
# does.

def _tc(monkeypatch, seg_tiles=None):
    monkeypatch.setattr(SKM, "uses_tc",
                        lambda sp, batchsize: SKM.tc_reason(sp) is None)
    if seg_tiles is not None:
        monkeypatch.setattr(SKM, "TC_SEG_TILES", seg_tiles)


def _tc_grads_cover(sp, items, n_seg):
    """Per segment, how many W items (and bias sums) own each parameter."""
    prog = sp.packed(SKM.TC_ROWS, keep_deltas=True).prog.numpy()
    count = np.zeros((n_seg, sp.n_params), np.int64)
    for word, m0, n0, seg in items:
        ins = prog[word:word + 16]
        k, w, n, bias = ins[2], ins[3], ins[4], ins[6]
        m1, n1 = min(k, m0 + SKM.TC_ITEM), min(n, n0 + SKM.TC_ITEM)
        rows = w + np.arange(m0, m1)[:, None] * n + np.arange(n0, n1)[None]
        count[seg, rows.ravel()] += 1
        if bias >= 0 and m0 == 0:
            count[seg, bias + np.arange(n0, n1)] += 1
    return count


@pytest.mark.parametrize("guard,weighted", [(False, True), (True, False)])
@pytest.mark.parametrize("variant", ["reference", "joint", "clamped", "nice",
                                     "nobias_tanh"])
def test_tc_design_emulated_equals_plain_version(emulated, monkeypatch,
                                                 variant, guard, weighted):
    """The tensor-core design: 3 epochs of batch 32 over 123 rows (a ragged
    last batch, the tile's other 32 rows masked), with and without the guard
    and the importance weights (one fully masked row group): parameters,
    moments, snapshots and per-step losses against
    ``fused_train_stream_plain`` at TRAIN_ATOL."""
    _tc(monkeypatch)
    case = StreamCase(variant)
    kw = dict(guard_nonfinite=guard, w=case.w if weighted else None)
    shape = SKM.launch_shape(case.sp, 32)
    assert shape.tc and shape.tile == SKM.TC_ROWS
    _assert_runs(case.run(emulated(96, 0), **kw), case.run(**kw), TRAIN_ATOL)


def test_tc_design_emulated_is_independent_of_order_and_grid(emulated,
                                                             monkeypatch):
    """Threads and blocks of every grid phase in either order, other thread
    counts and other grids give the same bits: every output of a tile, a W
    item, a segment's loss and an Adam entry has one owner and a fixed
    order, so the bits do not depend on the grid. Batches of 96 rows (two
    tiles, the second half masked) in segments of one tile."""
    _tc(monkeypatch, seg_tiles=1)
    case = StreamCase("reference")
    kw = dict(batchsize=96)
    runs = [case.run(emulated(nt, rev), n_blocks=nb, **kw)
            for nt, rev, nb in ((96, 0, None), (96, 1, None), (64, 2, 3),
                                (32, 3, 1), (1024, 0, 5))]
    for other in runs[1:]:
        _assert_runs(other, runs[0], 0)
    _assert_runs(runs[0], case.run(**kw), TRAIN_ATOL)


def test_tc_design_emulated_guard_skips_and_chunks(emulated, monkeypatch):
    """NaN rows poison the batches that gather them: with the guard the
    tensor-core design skips the steps the plain version skips, keeps the
    parameters finite and counts the skips; two chunked launches with the
    state and the count carried equal one launch, bit for bit."""
    _tc(monkeypatch, seg_tiles=1)
    case = StreamCase("joint", epochs=4)
    x = case.x.clone()
    x[[5, 40, 77], 1] = float("nan")
    case.x = x
    kw = dict(guard_nonfinite=True, batchsize=64)
    launch = emulated(96, 0)
    got = case.run(launch, **kw)
    want = case.run(**kw)
    assert got[4].tolist() == want[4].tolist() and int(got[4].sum()) > 0
    _assert_runs(got, want, TRAIN_ATOL)
    for p in got[0] + got[1] + got[2]:
        assert bool(torch.isfinite(p).all())
    n_batches = -(-case.x.shape[0] // 64)
    a = case.run(launch, perms=case.perms[:2], **kw)
    b = case.run(launch, perms=case.perms[2:], state=a[:3],
                 count0=2 * n_batches - int(a[4].sum()), **kw)
    for i in (0, 1, 2):
        for u, v in zip(got[i], b[i]):
            assert torch.equal(u, v)
    for k in range(len(got[3])):
        assert torch.equal(got[3][k], torch.cat([a[3][k], b[3][k]]))
    assert got[4].tolist() == a[4].tolist() + b[4].tolist()
    assert torch.equal(got[5].nan_to_num(), torch.cat([a[5], b[5]]).nan_to_num())


def _wide_step_plan(d, n, hidden, blocks):
    """The StepPlan of a chain of ``blocks`` coupling blocks (split s / t
    nets of two hidden layers), then a normalization layer."""
    g = torch.Generator().manual_seed(0)
    kw = dict(n=n, hidden_dim_s=hidden, hidden_dim_t=hidden, n_sublayers_s=2,
              n_sublayers_t=2, generator=g, device="cpu")
    halves = (list(range(d // 2, d)), list(range(d // 2)))
    x_ref = np.random.default_rng(0).normal(size=(64, d)).astype(np.float32)
    chain = dt.flow_chain(*[dt.coupling_block(d, halves[0], **kw)
                            for _ in range(blocks)],
                          dt.normalization_layer(x_ref, -1.0, 1.0,
                                                 device="cpu"))
    meta = dt.MetaData("", d, n, -np.ones(n, np.float32),
                       np.ones(n, np.float32))
    return FT.fold_for_step(dt.Flow(chain, meta, device="cpu")).step_plan


def test_tc_launch_rule_routes_by_plan_shape(cond):
    """The design comes from the plan's shape and the batch alone (the
    crossover measured on an H100): the 32-D emulator's chain (hidden 256,
    8 couplings; 4-row tiles in the tile body) takes the tensor-core design
    at batch 8192 and 1024, d 16 / hidden 64 or 128 at batch 1024 (one
    round of 8-row tiles) keep the tile body and take the tensor-core
    design at batch 8192; the tests' small chains keep the tile body; a
    chain with an ActNorm layer never takes it. ``launch_shape`` takes no
    argument that picks the design."""
    wide = _wide_step_plan(32, 8, 256, 4)
    shape = SKM.launch_shape(wide, 8192)
    assert shape.tc and shape[:5] == (SKM.TC_ROWS, SKM.TC_THREADS,
                                      SKM.TC_SHARED_BYTES, 128, False)
    assert SKM.launch_shape(wide, 8192, co_resident=132).n_blocks == 132
    assert SKM.launch_shape(wide, 1024).tc
    for h in (64, 128):
        narrow = _wide_step_plan(16, 4, h, 2)
        assert not SKM.launch_shape(narrow, 1024).tc
        assert SKM.launch_shape(narrow, 8192).tc
    jd, td, x = cond
    for variant in ("reference", "actnorm"):
        chain = to_torch(CHAINS[variant](jd, x))
        plan, tc, tparams, masks, slots, cparams, _f, _u = \
            FT.chain_train_fold(chain)
        sp = SK.StepPlan(plan, tparams, masks, slots, cparams, 5, 1, tc)
        assert not SKM.launch_shape(sp, 1024).tc
    assert SKM.tc_reason(sp).startswith("an ActNorm layer")
    assert SKM.tc_reason(wide) is None
    import inspect
    assert list(inspect.signature(SKM.launch_shape).parameters) == [
        "sp", "batchsize", "co_resident", "n_blocks", "stage"]
    with pytest.raises(ValueError, match="stages no parameters"):
        SKM.launch_shape(wide, 8192, stage=True)


def test_tc_launch_rule_keeps_the_tile_body_past_the_workspace_budget(
        monkeypatch):
    """The tensor-core design's workspace grows with the batch: at a batch
    whose workspace passes ``TC_WORKSPACE_BYTES`` (half of train()'s
    per-call device budget) the rule keeps the tile body, which takes no
    workspace; the limit is inclusive."""
    wide = _wide_step_plan(32, 8, 256, 4)
    assert 2 * SKM.TC_WORKSPACE_BYTES == FT._STREAM_DEVICE_BUDGET
    big = 1 << 20
    assert SKM._tc_workspace_bytes(wide, big) > SKM.TC_WORKSPACE_BYTES
    assert not SKM.uses_tc(wide, big)
    assert not SKM.launch_shape(wide, big).tc
    assert SKM.stream_workspace_bytes(wide, big) == 0
    ws = SKM.stream_workspace_bytes(wide, 8192)
    assert 0 < ws == SKM._tc_workspace_bytes(wide, 8192)
    monkeypatch.setattr(SKM, "TC_WORKSPACE_BYTES", ws)
    assert SKM.launch_shape(wide, 8192).tc
    monkeypatch.setattr(SKM, "TC_WORKSPACE_BYTES", ws - 1)
    assert not SKM.launch_shape(wide, 8192).tc
    assert SKM.stream_workspace_bytes(wide, 8192) == 0


@pytest.mark.parametrize("batchsize", [32, 8192])
def test_tc_items_own_every_gradient_once_per_segment(batchsize):
    """The W items of the 32-D emulator's plan: in every segment each
    folded parameter (weights and biases) belongs to exactly one item, the
    largest items first."""
    sp = _wide_step_plan(32, 8, 256, 4)
    items = SKM.tc_items(sp, batchsize)
    n_tiles, n_seg = SKM._tc_counts(batchsize)
    assert n_seg == -(-n_tiles // SKM.TC_SEG_TILES)
    assert (_tc_grads_cover(sp, items, n_seg) == 1).all()
    assert set(items[:, 3].tolist()) == set(range(n_seg))


def test_tc_workspace_bytes_match_what_the_wrapper_allocates(
        emulated, monkeypatch):
    """``stream_workspace_bytes`` is the workspace a launch allocates (the
    tiles' layout rounded up to 16 bytes, their losses, the weights' two
    planes), 0 for the tile body, and ``stream_chunk_epochs`` keeps it out
    of the epochs' budget."""
    _tc(monkeypatch)
    case = StreamCase("reference")
    allocated = []
    real = SKM._workspace

    def spy(*a, **k):
        allocated.append(real(*a, **k))
        return allocated[-1]

    monkeypatch.setattr(SKM, "_workspace", spy)
    case.run(emulated(96, 0), batchsize=100)
    pk = case.sp.packed(SKM.TC_ROWS, keep_deltas=True)
    align = lambda v: -(-v // 4) * 4     # noqa: E731
    want = 4 * (2 * align(pk.total_floats) + align(2)
                + 2 * align(case.sp.n_params))
    assert [t.numel() * 4 for t in allocated] == [want]
    assert SKM.stream_workspace_bytes(case.sp, 100) == want
    monkeypatch.setattr(SKM, "uses_tc", lambda sp, batchsize: False)
    assert SKM.stream_workspace_bytes(case.sp, 100) == 0
    budget = FT._STREAM_DEVICE_BUDGET
    per_epoch = 4 * (1024 + 1000)
    for ws in (0, budget // 2):
        e_max = (budget - ws) // per_epoch
        assert FT.stream_chunk_epochs(1000, 1024, 64, 3 * e_max, ws) == e_max


def test_stream_kernel_source_is_hand_written():
    csrc = os.path.join(ROOT, "densityflows_tpu_torch", "csrc")
    with open(os.path.join(csrc, "stream_kernels.cu")) as f:
        text = f.read()
    for symbol in ("df_train_stream", "train_stream_kernel", "__global__",
                   "cudaLaunchCooperativeKernel", "this_grid", "grid.sync()",
                   "cudaOccupancyMaxActiveBlocksPerMultiprocessor",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "#include \"flow_phases.cuh\"",
                   "#include \"grads_tile.cuh\"",
                   "pallas_train_stream.py::_stream_kernel"):
        assert symbol in text
    for banned in ("atomicadd", "cublas", "cudnn", "cutlass",
                   "torch/extension.h"):
        assert banned not in text.lower()
