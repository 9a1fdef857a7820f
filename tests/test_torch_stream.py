"""The port's streaming path on the CPU against the JAX package: the native
host loader (``native.shuffle`` / ``gather_rows``, compiled and fallback),
``StreamingLoader`` and ``train_streaming`` with the plain step and with the
step kernel's wrapper (on the CPU: its plain version), on the same numpy
inputs and seeds.

Tolerances: the loader is bit-identical (integer permutations, copied rows).
Training runs float32 on both sides through a few epochs of Adam, summed in
another order: histories 1e-4, parameters 1e-3, as stated in each test.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu import native as jnative
from densityflows_tpu.data_stream import StreamingLoader as JaxLoader
from densityflows_tpu.data_stream import train_streaming as jax_train_streaming
from densityflows_tpu_torch import _build
from densityflows_tpu_torch import data_stream as DS
from densityflows_tpu_torch import native as tnative
from densityflows_tpu_torch.models.fused_train import UnsupportedFusedTrain

from _torch_parity import (
    assert_leaves_close,
    assert_opt_state_close,
    randomize,
    torch_flow,
)

HIST_ATOL, PARAM_ATOL = 1e-4, 1e-3


@pytest.fixture(params=["native", "fallback"])
def loader_mode(request, monkeypatch):
    """Both host paths of the port: the compiled library, and the numpy
    fallback of a machine without a compiler."""
    if request.param == "fallback":
        monkeypatch.setattr(tnative, "_load", lambda: None)
        assert not tnative.native_available()
    elif not tnative.native_available():
        pytest.skip("needs a host C++ compiler")
    return request.param


# -- native ---------------------------------------------------------------------

def test_native_library_is_built_into_the_build_directory():
    """The port compiles its OWN copy of the loader, into ``build/`` and not
    into its package directory."""
    assert tnative.native_available()
    pkg = os.path.dirname(os.path.abspath(tnative.__file__))
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert [f for f in os.listdir(_build.build_dir())
            if f.startswith("libloader_") and f.endswith(".so")]
    assert os.path.exists(_build.source_path("loader", ".cpp"))


def test_shuffle_is_bit_identical_to_the_jax_package(loader_mode):
    for seed, n in [(0, 1), (1, 17), (42, 1000), (2**63, 257),
                    (7 * 0x9E3779B9 + 3, 103), (2**64 + 5, 64)]:
        got = tnative.shuffle(seed, n)
        np.testing.assert_array_equal(got, jnative.shuffle(seed, n))
        np.testing.assert_array_equal(got, jnative._shuffle_py(seed, n))
        np.testing.assert_array_equal(np.sort(got), np.arange(n))
        assert got.dtype == np.int64


def test_splitmix64_mirror_equals_the_jax_package():
    state = 12345
    for _ in range(5):
        assert tnative.splitmix64_py(state) == jnative.splitmix64_py(state)
        state = tnative.splitmix64_py(state)[0]


def test_gather_rows_equals_the_jax_package(loader_mode, tmp_path):
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        src = rng.normal(size=(500, 7)).astype(dtype)
        idx = rng.integers(0, 500, size=123)
        got = tnative.gather_rows(src, idx)
        np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
        np.testing.assert_array_equal(got, src[idx])
        assert got.dtype == dtype and got.flags["C_CONTIGUOUS"]
        out = np.empty((123, 7), dtype)
        assert tnative.gather_rows(src, idx, out=out) is out
        np.testing.assert_array_equal(out, src[idx])
        # enough rows for the threaded path
        big = rng.normal(size=(5000, 64)).astype(dtype)
        idx_b = rng.integers(0, 5000, size=40000)
        np.testing.assert_array_equal(
            tnative.gather_rows(big, idx_b, n_threads=4), big[idx_b])
    # other types, zero-width rows and non-contiguous sources take the
    # fancy-indexing path
    src_i = rng.integers(0, 100, size=(50, 3)).astype(np.int32)
    idx = rng.integers(0, 50, size=20)
    np.testing.assert_array_equal(tnative.gather_rows(src_i, idx), src_i[idx])
    assert tnative.gather_rows(np.zeros((50, 0), np.float32), idx).shape \
        == (20, 0)
    np.testing.assert_array_equal(tnative.gather_rows(src[:, ::2], idx),
                                  src[:, ::2][idx])
    # an index outside the rows never reaches the library
    np.testing.assert_array_equal(
        tnative.gather_rows(src, np.array([-1, 0])), src[[-1, 0]])
    with pytest.raises(IndexError):
        tnative.gather_rows(src, np.array([0, src.shape[0]]))
    # a memory-mapped source
    path = tmp_path / "x.npy"
    np.save(path, src)
    np.testing.assert_array_equal(
        tnative.gather_rows(np.load(path, mmap_mode="r"), idx), src[idx])


# -- StreamingLoader ----------------------------------------------------------------

def _rows(n, d=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    theta = np.arange(n, dtype=np.float32)[:, None]
    return x, theta


def _same_epoch(port, ref, epoch):
    got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
    assert len(got) == len(want) == port.batches_per_epoch
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    return got


@pytest.mark.parametrize("kw", [
    dict(batchsize=16, seed=3),
    dict(batchsize=16, seed=3, shuffle=False),
    dict(batchsize=103, seed=0),
    dict(batchsize=7, seed=2**40 + 1),
], ids=["shuffled", "in_order", "one_batch", "large_seed"])
def test_streaming_loader_yields_the_jax_loaders_batches(loader_mode, kw):
    """Every batch of two epochs equals the JAX loader's, bit for bit; an
    epoch covers each row once; another epoch has another order."""
    x, theta = _rows(103)
    port, ref = DS.StreamingLoader(x, theta, **kw), JaxLoader(x, theta, **kw)
    assert port.batches_per_epoch == ref.batches_per_epoch
    assert port.rows_per_host == ref.rows_per_host == 103
    seen = []
    for e in (0, 1):
        rows = []
        for xb, thb, mask in _same_epoch(port, ref, e):
            assert xb.shape == (kw["batchsize"], 4)
            valid = mask.astype(bool)
            rows.extend(thb[valid, 0].astype(int).tolist())
            np.testing.assert_array_equal(
                xb[valid], x[thb[valid, 0].astype(int)])
        assert sorted(rows) == list(range(103))
        seen.append(rows)
    assert (seen[0] != seen[1]) == kw.get("shuffle", True)


@pytest.mark.parametrize("n,hosts,batchsize", [(40, 3, 8), (9, 4, 2),
                                               (64, 2, 16)])
def test_streaming_loader_host_shards_partition_the_global_permutation(
        loader_mode, n, hosts, batchsize):
    """Per-host shards of one epoch are disjoint, cover every row, equal the
    JAX loader's shards, and run the SAME number of batches: a host without
    rows left yields fully masked padding batches."""
    x = np.arange(n, dtype=np.float32)[:, None]
    shards, counts = [], set()
    for h in range(hosts):
        kw = dict(batchsize=batchsize, seed=7, host_id=h, num_hosts=hosts)
        port, ref = DS.StreamingLoader(x, **kw), JaxLoader(x, **kw)
        batches = _same_epoch(port, ref, 0)
        rows = [int(v) for xb, _, m in batches for v in xb[m.astype(bool), 0]]
        assert len(rows) == port.rows_per_host == ref.rows_per_host
        counts.add(len(batches))
        shards.append(rows)
        for xb, thb, m in batches:
            assert thb.shape == (batchsize, 0)
            assert bool((xb[~m.astype(bool)] == x[0]).all())  # pad rows
    assert len(counts) == 1
    assert sorted(r for s in shards for r in s) == list(range(n))
    order = tnative.shuffle(7 * 0x9E3779B9 + 1, n)
    assert [r for s in shards for r in s] == order.tolist()
    if (n, hosts) == (9, 4):
        assert shards[3] == []      # only padding batches on the last host


def test_streaming_loader_memmap_source_and_default_iteration(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    xm = np.load(path, mmap_mode="r")
    loader = DS.StreamingLoader(xm, batchsize=32, shuffle=False)
    xb, thb, mask = next(iter(loader))
    np.testing.assert_array_equal(xb, x[:32])
    assert thb.shape == (32, 0) and mask.sum() == 32
    # iter() walks the epochs in turn
    shuffled = DS.StreamingLoader(xm, batchsize=200, seed=4)
    ref = JaxLoader(xm, batchsize=200, seed=4)
    for _ in range(2):
        np.testing.assert_array_equal(next(iter(shuffled))[0],
                                      next(iter(ref))[0])
    assert shuffled._epoch == 2


def test_streaming_loader_validates_inputs_and_hands_on_a_failure():
    x = np.zeros((10, 2), np.float32)
    with pytest.raises(ValueError, match="rows, d"):
        DS.StreamingLoader(np.zeros((10,), np.float32))
    with pytest.raises(ValueError, match="theta has 9"):
        DS.StreamingLoader(x, np.zeros((9, 1), np.float32))
    with pytest.raises(ValueError, match="host_id"):
        DS.StreamingLoader(x, host_id=2, num_hosts=2)

    class Broken(np.ndarray):
        def __getitem__(self, item):
            raise OSError("disk gone")

    loader = DS.StreamingLoader(x.astype(np.int32).view(Broken), batchsize=4)
    with pytest.raises(OSError, match="disk gone"):
        list(loader.epoch(0))


def test_stager_gives_float32_tensors_on_the_cpu():
    stage = DS._Stager("cpu", 4, 3, 1)
    xb, thb, m = stage(np.ones((4, 3), np.float64), np.zeros((4, 1)),
                       np.ones(4, np.float32))
    assert xb.dtype == thb.dtype == m.dtype == torch.float32
    assert xb.shape == (4, 3) and thb.shape == (4, 1) and m.shape == (4,)


# -- train_streaming ----------------------------------------------------------------

def _stream_case(conditional):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    if conditional:
        th = rng.uniform(-1, 2, size=(300, 1)).astype(np.float32)
        jdata, tdata = (df.DataArrays.make(x, th, rng=0),
                        dt.DataArrays.make(x, th, rng=0))
        chain = df.flow_chain(
            df.coupling_layer(jdata, [0, 1], key=jax.random.key(0),
                              hidden_dim_s=8, hidden_dim_t=8),
            df.coupling_layer(jdata, [2, 3], key=jax.random.key(1),
                              joint_conditioner=True, hidden_dim_s=8,
                              hidden_dim_t=8),
            df.normalization_layer(x, -1.0, 1.0))
    else:
        th = None
        jdata, tdata = df.DataArrays.make(x, rng=0), dt.DataArrays.make(x, rng=0)
        chain = df.flow_chain(
            df.coupling_layer(jdata, [0, 1], key=jax.random.key(0),
                              hidden_dim_s=8, hidden_dim_t=8),
            df.actnorm_layer(x),
            df.coupling_layer(jdata, [2, 3], key=jax.random.key(1),
                              kind=df.NICECouplingLayer, hidden_dim_t=8),
            df.normalization_layer(x, -1.0, 1.0))
    chain = randomize(chain, 11)

    def build():
        jflow = df.Flow(chain, jdata)
        return jflow, torch_flow(jflow, tdata)

    valid = (x[:60], None if th is None else th[:60])
    return x, th, valid, build


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("conditional", [True, False],
                         ids=["conditional", "unconditional"])
def test_train_streaming_equals_the_jax_package(monkeypatch, conditional,
                                                fused):
    """Three epochs on the same data, seed and loader order, then two more
    from the OTHER package's optimizer state: histories 1e-4, parameters and
    Adam moments 1e-3, equal Adam counts. ``fused``: the JAX side runs its
    step kernel (interpreted, its routing forced as its own tests force it),
    the port the wrapper's plain version; else both run their plain step."""
    x, th, valid, build = _stream_case(conditional)
    kw = dict(epochs=3, batchsize=32, seed=7, verbose=False, valid_data=valid)
    if fused:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jflow, tflow = build()
    jstate = jax_train_streaming(jflow, x, th, df.adam(2e-3), **kw)
    tstate = dt.train_streaming(tflow, x, th, dt.adam(2e-3),
                                fused_kernel=fused, **kw)
    if fused:
        assert jflow.trained_path == tflow.trained_path == "fused-step"
        assert tflow.fused_decline_reason is None
    else:
        assert tflow.trained_path == "torch"
        assert tflow.fused_decline_reason == "fused_kernel=False"
    assert len(tflow.train_loss) == len(tflow.valid_loss) == 3
    np.testing.assert_allclose(tflow.train_loss, jflow.train_loss,
                               rtol=0, atol=HIST_ATOL)
    np.testing.assert_allclose(tflow.valid_loss, jflow.valid_loss,
                               rtol=0, atol=HIST_ATOL)
    assert_leaves_close(jflow.model, tflow.model, PARAM_ATOL)
    assert tstate.count == int(jstate[0].count) == 3 * 10
    assert_opt_state_close(jstate, tflow.model, tstate, PARAM_ATOL)

    # resume: the JAX package's state, carried across, continues the port
    carried = dt.adam_state_from_jax_leaves(
        tflow.model, [np.asarray(l) for l in
                      jax.tree_util.tree_leaves(jstate)])
    kw.update(epochs=2, seed=9)
    jstate = jax_train_streaming(jflow, x, th, df.adam(2e-3),
                                 opt_state=jstate, **kw)
    tstate = dt.train_streaming(tflow, x, th, dt.adam(2e-3),
                                opt_state=carried, fused_kernel=fused, **kw)
    np.testing.assert_allclose(tflow.train_loss, jflow.train_loss,
                               rtol=0, atol=HIST_ATOL)
    np.testing.assert_allclose(tflow.valid_loss, jflow.valid_loss,
                               rtol=0, atol=HIST_ATOL)
    assert_leaves_close(jflow.model, tflow.model, PARAM_ATOL)
    assert tstate.count == int(jstate[0].count) == 5 * 10
    assert_opt_state_close(jstate, tflow.model, tstate, PARAM_ATOL)


def test_train_streaming_fused_and_plain_steps_continue_each_other():
    """A state returned by one step kind resumes the other: plain → fused
    equals plain → plain (1e-4 on histories, 1e-3 on parameters)."""
    x, th, valid, build = _stream_case(True)
    kw = dict(batchsize=32, verbose=False, valid_data=valid)
    flows = [build()[1] for _ in range(2)]
    for flow, second in zip(flows, (False, True)):
        state = dt.train_streaming(flow, x, th, dt.adam(2e-3), epochs=2,
                                   seed=1, fused_kernel=False, **kw)
        dt.train_streaming(flow, x, th, dt.adam(2e-3), state, epochs=2,
                           seed=2, fused_kernel=second, **kw)
    assert flows[1].trained_path == "fused-step"
    np.testing.assert_allclose(flows[1].train_loss, flows[0].train_loss,
                               rtol=0, atol=HIST_ATOL)
    for a, b in zip(flows[0].model.parameters(), flows[1].model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=PARAM_ATOL)


def test_train_streaming_logs_prints_and_keeps_the_contract(tmp_path,
                                                            capsys):
    x, th, valid, build = _stream_case(True)
    flow = build()[1]
    log = str(tmp_path / "run" / "metrics.jsonl")
    state = dt.train_streaming(flow, x, th, epochs=2, batchsize=64, seed=5,
                               valid_data=valid, metrics_log=log,
                               fused_kernel=True)
    out = capsys.readouterr().out
    assert "epoch: 1 | train_loss = " in out and "valid_loss = " in out
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs[1]["train_nll"] == flow.train_loss[1]
    assert recs[1]["valid_nll"] == flow.valid_loss[1]
    assert isinstance(state, dt.AdamState) and state.count == 2 * 5
    assert flow.train_loss[-1] < flow.train_loss[0]
    # the final validation NLL is the unfolded model's own
    with torch.no_grad():
        lp = flow.log_prob(torch.as_tensor(valid[0]),
                           torch.as_tensor(valid[1]))
    np.testing.assert_allclose(float(-lp.mean()), flow.valid_loss[-1],
                               atol=HIST_ATOL)
    # without validation data no validation history is written
    dt.train_streaming(flow, x, th, epochs=1, batchsize=64, verbose=False)
    assert len(flow.train_loss) == 3 and len(flow.valid_loss) == 2


def test_train_streaming_declines_are_recorded_and_forcing_raises():
    x, th, valid, build = _stream_case(True)

    class OtherOptimizer(dt.Adam):
        pass

    flow = build()[1]
    dt.train_streaming(flow, x, th, epochs=1, verbose=False)
    assert flow.trained_path == "torch"
    assert flow.fused_decline_reason == "non-CUDA device (cpu)"
    with pytest.raises(UnsupportedFusedTrain, match="adam"):
        dt.train_streaming(flow, x, th, OtherOptimizer(), epochs=1,
                           verbose=False, fused_kernel=True)
    with pytest.raises(UnsupportedFusedTrain, match="Adam state"):
        dt.train_streaming(flow, x, th, dt.adam(), object(), epochs=1,
                           verbose=False, fused_kernel=True)
    # a chain the kernel cannot fold
    g = torch.Generator().manual_seed(0)
    tdata = dt.DataArrays.make(x, th, rng=0)
    odd = dt.Flow(dt.flow_chain(
        dt.coupling_layer(tdata, [0, 1], generator=g, device="cpu",
                          activation_s="gelu"),
        dt.normalization_layer(x, -1.0, 1.0, device="cpu")), tdata,
        device="cpu")
    with pytest.raises(UnsupportedFusedTrain, match="gelu"):
        dt.train_streaming(odd, x, th, epochs=1, verbose=False,
                           fused_kernel=True)
    with pytest.raises(ValueError, match="num_hosts"):
        dt.train_streaming(flow, x, th, epochs=1, verbose=False,
                           mesh=dt.Mesh(None, 2, 0), num_hosts=3)
