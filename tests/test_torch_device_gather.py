"""``DataArrays.normalized_splits_on``: the training and validation splits
picked and normalized on the flow's device, against the host getters
(``normalized_training_data`` / ``normalized_validation_data``, the weights'
rows) followed by a float32 copy, bit for bit; the rule that keeps the host
gather, and the ``dev`` count of its ``df.gather`` span; and ``train()``
through the whole-run kernel's plain version and through the plain program,
bit for bit against the host gather. The ``gpu`` test makes the comparison
on a card at the emulator32 configuration's widths:

    python -m pytest tests/test_torch_device_gather.py -m gpu -q
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import densityflows_tpu_torch as dt
from densityflows_tpu_torch import data as D
from densityflows_tpu_torch.utils import spans as S

import _torch_cpu  # noqa: F401

NAMES = ("x_train", "th_train", "x_valid", "th_valid", "w_train", "w_valid")


def _host_splits(data, meta, device, weights=None):
    """The host getters followed by the float32 copy they had before."""
    x_t, th_t = data.normalized_training_data(meta)
    x_v, th_v = data.normalized_validation_data(meta)
    w_t = w_v = None
    if weights is not None:
        w = np.asarray(weights, np.float32).reshape(-1)
        w_t, w_v = w[data.partition.training], w[data.partition.validation]
    return tuple(None if a is None else D._put(a, device)
                 for a in (x_t, th_t, x_v, th_v, w_t, w_v))


def _assert_same_bits(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.device == w.device, name
        assert g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


def _gather_counts(fn):
    """``fn()`` under a profiler; its ``df.gather`` spans' counts."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [s.counts for s in S.recorded(t0, time.time_ns())
                 if s.name == "df.gather"]


def _case(name, rows=240, d=5, n=3):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    th = rng.uniform(-1.0, 2.0, (rows, n)).astype(np.float32)
    weights = None
    part = dt.DataPartition.make(rows, rng=3)
    if name == "x_float64":
        x = rng.normal(size=(rows, d))
    elif name == "theta_float64":
        th = th.astype(np.float64) + 1e-9 * rng.normal(size=th.shape)
    elif name == "zero_range":
        th[:, 1] = 0.5
    elif name == "unconditional":
        th = dt.dflt_theta(x)
    elif name == "weights":
        weights = rng.uniform(0.1, 2.0, rows)
    elif name == "one_row_validation":
        p = rng.permutation(rows)
        part = dt.DataPartition(p[:rows - 1], p[rows - 1:], p[:0])
    data = dt.DataArrays(x, th, part)
    meta = data.metadata()
    if name == "bounds_float64":
        meta = dt.MetaData("", d, n, meta.theta_min.astype(np.float64) - 0.1,
                           meta.theta_max.astype(np.float64) + 1e-3)
    return data, meta, weights


@pytest.mark.parametrize("name", [
    "float32", "x_float64", "bounds_float64", "theta_float64", "zero_range",
    "unconditional", "weights", "one_row_validation"])
def test_device_gather_is_the_host_gather_bit_for_bit(name):
    data, meta, weights = _case(name)
    out, counts = _gather_counts(
        lambda: data.normalized_splits_on(meta, "cpu", weights))
    assert counts == [{"dev": 1}]
    _assert_same_bits(out, _host_splits(data, meta, "cpu", weights))
    if name == "bounds_float64":
        # float32 θ against float64 bounds normalizes in float64, as NumPy
        # does: the float32 arithmetic gives other bits
        th32 = dt.normalize_input(torch.as_tensor(
            data.theta[data.partition.training]),
            torch.as_tensor(meta.theta_min.astype(np.float32)),
            torch.as_tensor(meta.theta_max.astype(np.float32)))
        assert not torch.equal(th32, out[1])
    if name == "zero_range":
        assert torch.all(out[1][:, 1] == 0) and torch.all(out[3][:, 1] == 0)


@pytest.mark.parametrize("name", ["large_testing", "negative_index",
                                  "float16_theta"])
def test_the_host_gathers_where_the_rule_says(name):
    rows = 240
    rng = np.random.default_rng(11)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    th = rng.uniform(size=(rows, 2)).astype(np.float32)
    if name == "large_testing":
        # training and validation rows fewer than half of the rows: the raw
        # copy would carry more than twice the splits' bytes
        part = dt.DataPartition.make(rows, 0.3, 0.1, rng=1)
    elif name == "negative_index":
        part = dt.DataPartition.make(rows, rng=1)
        part = dt.DataPartition(part.training - rows, part.validation,
                                part.testing)
    else:
        th = th.astype(np.float16)
        part = dt.DataPartition.make(rows, rng=1)
    data = dt.DataArrays(x, th, part)
    meta = data.metadata()
    out, counts = _gather_counts(
        lambda: data.normalized_splits_on(meta, "cpu"))
    assert counts == [{"dev": 0}]
    _assert_same_bits(out, _host_splits(data, meta, "cpu"))


def test_an_index_out_of_range_raises_as_numpy_does():
    data, meta, _ = _case("float32")
    part = data.partition
    bad = dt.DataArrays(data.x, data.theta, dt.DataPartition(
        np.append(part.training, data.x.shape[0]), part.validation,
        part.testing))
    with pytest.raises(IndexError):
        bad.normalized_splits_on(meta, "cpu")


def test_weights_of_the_wrong_length_raise():
    data, meta, _ = _case("float32")
    with pytest.raises(ValueError, match="one entry per data row"):
        data.normalized_splits_on(meta, "cpu", np.ones(7))


def _flow_case():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    th = rng.uniform(-1.0, 2.0, (300, 2)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=2)
    chain = dt.flow_chain(dt.coupling_block(
        4, None, n=2, generator=torch.Generator().manual_seed(0),
        hidden_dim_s=8, hidden_dim_t=8, device="cpu"))
    return dt.Flow(chain, data, device="cpu"), data, rng.uniform(0.5, 1.5, 300)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("route", ["fused", "plain"])
def test_train_is_bit_identical_to_the_host_gather(monkeypatch, route,
                                                   weighted):
    runs = []
    for on_device in (True, False):
        if not on_device:
            monkeypatch.setattr(D, "_gathers_on_device",
                                lambda *a: False)
        flow, data, w = _flow_case()
        state = dt.train(flow, data, epochs=2, batchsize=64, verbose=False,
                         generator=torch.Generator().manual_seed(3),
                         weights=w if weighted else None,
                         fused_kernel=route == "fused")
        runs.append((flow, state))
    (flow, state), (ref, ref_state) = runs
    assert flow.trained_path == ref.trained_path
    assert (flow.trained_path == "fused") == (route == "fused")
    assert flow.train_loss == ref.train_loss
    assert flow.valid_loss == ref.valid_loss
    assert state.count == ref_state.count
    pairs = list(zip(flow.model.parameters(), ref.model.parameters()))
    pairs += list(zip(state.mu, ref_state.mu)) + list(zip(state.nu,
                                                          ref_state.nu))
    assert pairs
    for a, b in pairs:
        assert torch.equal(a.detach().view(torch.int32),
                           b.detach().view(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the comparison is the card's "
                    "arithmetic against NumPy's")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bounds", ["float32", "float64"])
def test_device_gather_on_the_card(cuda, bounds):
    """emulator32's widths (d 32, 8 conditions over the box [-1, 2]^8) at
    2^16 rows in a shuffled split, with weights."""
    rows = 1 << 16
    rng = np.random.default_rng(13)
    x = rng.normal(size=(rows, 32)).astype(np.float32)
    th = rng.uniform(-1.0, 2.0, (rows, 8)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=4)
    meta = data.metadata()
    if bounds == "float64":
        meta = dt.MetaData("", 32, 8, np.full(8, -1.0), np.full(8, 2.0))
    w = rng.uniform(0.5, 1.5, rows)
    out, counts = _gather_counts(
        lambda: data.normalized_splits_on(meta, cuda, w))
    assert counts == [{"dev": 1}]
    _assert_same_bits(out, _host_splits(data, meta, cuda, w))
