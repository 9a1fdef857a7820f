"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA chain
kernels, the whole-run train kernels (resident and streaming), the
grads-only step kernel and the per-layer coupling kernels against their plain
versions. They skip where there is no card; run them on a machine
with one with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` makes the same comparisons at full width."""

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_chain as TF
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.ops import chain_kernels as CK
from densityflows_tpu_torch.ops import coupling_kernels as CPK
from densityflows_tpu_torch.ops import step_kernels as SK
from densityflows_tpu_torch.ops import stream_kernels as STK
from densityflows_tpu_torch.ops import train_kernels as TK

import _torch_cpu  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _chain(device, d=7, n=3, h=18):
    g = torch.Generator().manual_seed(0)
    x_ref = np.random.default_rng(0).normal(size=(64, d)).astype(np.float32)
    kw = dict(generator=g, device=device, zero_init_final=False,
              hidden_dim_s=h, hidden_dim_t=h)
    return dt.flow_chain(
        dt.coupling_block(d, None, n=n, **kw),
        dt.permutation_layer(d, generator=g),
        dt.coupling_layer(d, 3, n=n, kind=dt.NICECouplingLayer, **kw),
        dt.coupling_layer(d, 3, n=n, joint_conditioner=True,
                          max_log_scale=2.0, **kw),
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))


@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_chain_apply_kernel_matches_plain(cuda, dirn):
    chain = _chain(cuda)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(1001, 7)).astype(np.float32)).to(cuda)
    th = torch.as_tensor(rng.uniform(size=(1001, 3)).astype(np.float32)).to(cuda)
    plan, params = TF._plan_params(chain, dirn)
    before = CK.run_chain.launches
    y, ldj = CK.run_chain(plan, params, x, th, with_ldj=True)
    torch.cuda.synchronize()
    assert CK.run_chain.launches == before + 1
    yr, lr = CK.chain_apply_plain(plan, params, x, th, with_ldj=True)
    # f32 FMA in another summation order than the library's products
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ldj, lr, rtol=1e-4, atol=1e-4)


def test_chain_sample_kernel_matches_plain_fold_of_its_noise(cuda):
    chain = _chain(cuda)
    plan, params = TF._plan_params(chain, "fwd")
    th = torch.full((1, 3), 0.5, device=cuda)
    y, r = CK.run_chain_sample(plan, params, 4097, 7, th, seed=7,
                               return_noise=True)
    torch.cuda.synchronize()
    ref = CK.chain_sample_plain(plan, params, 4097, 7, th, noise=r)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r.cpu().numpy(),
                               CK.philox_normal_reference(7, 4097, 7),
                               atol=1e-5)


def _train_case(device, weighted):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(137, 5)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(137, 1)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device=device, zero_init_final=False,
              hidden_dim_s=16, hidden_dim_t=16)
    chain = dt.flow_chain(
        dt.coupling_layer(data, [0, 1, 2], **kw),
        dt.actnorm_layer(x, device=device),
        dt.coupling_layer(data, [2, 3, 4], joint_conditioner=True,
                          max_log_scale=0.5, **kw),
        dt.permutation_layer([4, 2, 0, 3, 1]),
        dt.coupling_layer(data, [4, 0, 1], kind=dt.NICECouplingLayer, **kw),
        dt.normalization_layer(x, -1.0, 1.0, device=device))
    flow = dt.Flow(chain, data, device=device)
    fold = FT.chain_train_fold(chain)
    xt, tht = data.normalized_training_data(flow.metadata)
    xv, thv = data.normalized_validation_data(flow.metadata)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    arrays = (put(xt), put(tht), put(xv), put(thv))
    perms = np.stack([rng.permutation(xt.shape[0]) for _ in range(4)])
    kw = dict(batchsize=32, track_best=True, guard_nonfinite=True)
    if weighted:
        kw.update(w=put(rng.uniform(0.3, 2.0, size=xt.shape[0])),
                  w_valid=put(rng.uniform(0.3, 2.0, size=xv.shape[0])))
    return fold, arrays, perms, kw


@pytest.mark.parametrize("weighted", [False, True])
def test_train_run_kernel_matches_plain(cuda, weighted):
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), arrays, perms, kw = \
        _train_case(cuda, weighted)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros)
    before = TK.run_fused_train.launches
    got = TK.run_fused_train(*head, *arrays, perms, **kw)
    torch.cuda.synchronize()
    assert TK.run_fused_train.launches == before + 1
    want = TK.fused_train_plain(*head, *arrays, perms, **kw)
    # the same f32 arithmetic in another summation order, 4 epochs of Adam
    for i in (0, 1, 2, 5):
        for a, b in zip(got[i], want[i]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-4)
    assert got[6].tolist() == want[6].tolist() == [0, 0, 0, 0]


def test_train_run_kernel_two_calls_equal_one(cuda):
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), arrays, perms, kw = \
        _train_case(cuda, True)
    zeros = [torch.zeros_like(p) for p in tparams]
    one = TK.run_fused_train(plan, tparams, masks, slots, cparams, zeros,
                             zeros, *arrays, perms, **kw)
    a = TK.run_fused_train(plan, tparams, masks, slots, cparams, zeros, zeros,
                           *arrays, perms[:2], **kw)
    n_batches = -(-arrays[0].shape[0] // 32)
    b = TK.run_fused_train(plan, a[0], masks, slots, cparams, a[1], a[2],
                           *arrays, perms[2:], count0=2 * n_batches, **kw)
    torch.cuda.synchronize()
    for i in (0, 1, 2):
        for u, v in zip(one[i], b[i]):
            assert torch.equal(u, v)
    assert torch.equal(one[3], torch.cat([a[3], b[3]]))


def _step_case(device, rows=300):
    (plan, tc, tparams, masks, slots, cparams, _f, _u), arrays, _p, _kw = \
        _train_case(device, False)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, arrays[0].shape[0], size=rows)
    x, th = arrays[0][idx].contiguous(), arrays[1][idx].contiguous()
    mask = torch.as_tensor((rng.uniform(0.2, 2.0, size=rows)
                            * (np.arange(rows) < rows - 7)
                            ).astype(np.float32)).to(device)
    sp = SK.StepPlan(plan, tparams, masks, slots, cparams, 5, 1, tc)
    return sp, tparams, x, th, mask


@pytest.mark.parametrize("tile", [None, 8, 32])
def test_step_grads_kernel_matches_plain(cuda, tile):
    """A weighted batch of 300 rows with padded rows, no multiple of the
    tile: loss and gradients against the plain version at 1e-4 (the same f32
    arithmetic in another summation order); the counter moves by one."""
    sp, tparams, x, th, mask = _step_case(cuda)
    flat = sp.flatten(tparams)
    before = SK.run_fused_grads.launches
    loss, g = sp.grads(flat, x, th, mask, tile=tile)
    torch.cuda.synchronize()
    assert SK.run_fused_grads.launches == before + 1
    want_loss, want = SK.step_grads_plain(
        sp.plan, tparams, sp.masks, sp.mask_slots, sp.cparams, x, th, mask)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-4)
    torch.testing.assert_close(g, torch.cat([w.reshape(-1) for w in want]),
                               rtol=0, atol=1e-4)


def test_step_grads_kernel_is_deterministic_and_shards_sum(cuda):
    """Two launches give the same bits; two shards with the GLOBAL
    denominator sum to the whole batch (1e-5)."""
    sp, tparams, x, th, mask = _step_case(cuda, rows=256)
    flat = sp.flatten(tparams)
    a = sp.loss_and_grads(flat, x, th, mask).clone()
    b = sp.loss_and_grads(flat, x, th, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    denom = mask.sum()
    halves = [sp.loss_and_grads(flat, x[s], th[s], mask[s], denom=denom)
              for s in (slice(0, 128), slice(128, 256))]
    torch.testing.assert_close(halves[0] + halves[1], a, rtol=0, atol=1e-5)


def test_train_streaming_takes_the_step_kernel(cuda):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(500, 1)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device=cuda, zero_init_final=False,
              hidden_dim_s=16, hidden_dim_t=16)
    flow = dt.Flow(dt.flow_chain(
        dt.coupling_layer(data, [0, 1, 2], **kw),
        dt.coupling_layer(data, [2, 3, 4], **kw),
        dt.normalization_layer(x, -1.0, 1.0, device=cuda)), data, device=cuda)
    before = SK.run_fused_grads.launches
    state = dt.train_streaming(flow, x, th, epochs=2, batchsize=64,
                               verbose=False, valid_data=(x[:64], th[:64]))
    assert flow.trained_path == "fused-step"
    assert SK.run_fused_grads.launches == before + 2 * 8 == before + state.count
    assert flow.train_loss[1] < flow.train_loss[0]
    assert np.isfinite(flow.valid_loss).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_train_stream_kernel_matches_plain(cuda, weighted):
    """4 epochs of batch 32 over 123 rows (a ragged last batch), with the
    guard: parameters, moments, snapshots and per-step losses against the
    plain version at 1e-4 (the same f32 arithmetic in another order, through
    Adam); two launches give the same bits; the counter moves by one."""
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), arrays, perms, kw = \
        _train_case(cuda, weighted)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, arrays[0],
            arrays[1], perms)
    kw = dict(batchsize=32, guard_nonfinite=True, with_losses=True,
              w=kw.get("w"))
    before = STK.run_fused_train_stream.launches
    got = STK.run_fused_train_stream(*head, **kw)
    again = STK.run_fused_train_stream(*head, **kw)
    torch.cuda.synchronize()
    assert STK.run_fused_train_stream.launches == before + 2
    want = STK.fused_train_stream_plain(*head, **kw)
    for i in (0, 1, 2, 3):
        for a, b, c in zip(got[i], want[i], again[i]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
            assert torch.equal(a, c)
    torch.testing.assert_close(got[5], want[5], rtol=0, atol=1e-4)
    assert got[4].tolist() == want[4].tolist() == [0, 0, 0, 0]


def _tc_case(device, d=5, n=1, hidden=16, blocks=None, rows=137, batch=32,
             epochs=4):
    """A chain the tensor-core design of train_stream can run (no ActNorm):
    split, joint clamped and NICE couplings, a permutation; or ``blocks``
    coupling blocks of two hidden layers with ReLU, the benchmark's
    emulator32 shape. Its fold, training rows, batch order and weights."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(rows, n)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    kw = dict(n=n, generator=g, device=device, zero_init_final=False,
              hidden_dim_s=hidden, hidden_dim_t=hidden)
    if blocks is None:
        layers = [dt.coupling_layer(d, [0, 1, 2], **kw),
                  dt.coupling_layer(d, [2, 3, 4], joint_conditioner=True,
                                    max_log_scale=0.5, **kw),
                  dt.permutation_layer([4, 2, 0, 3, 1]),
                  dt.coupling_layer(d, [4, 0, 1],
                                    kind=dt.NICECouplingLayer, **kw)]
    else:
        kw.update(n_sublayers_s=2, n_sublayers_t=2, activation_s="relu",
                  activation_t="relu")
        layers = [dt.coupling_block(d, list(range(d // 2, d)), **kw)
                  for _ in range(blocks)]
    chain = dt.flow_chain(*layers,
                          dt.normalization_layer(x, -1.0, 1.0, device=device))
    fold = FT.chain_train_fold(chain)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    perms = np.stack([rng.permutation(rows) for _ in range(epochs)])
    return fold, (put(x), put(th)), perms, put(rng.uniform(0.3, 2.0, rows))


def _stream_bits_equal(a, b):
    return all(torch.equal(u, v) for i in (0, 1, 2, 3)
               for u, v in zip(a[i], b[i])) and \
        torch.equal(a[5].nan_to_num(), b[5].nan_to_num())


@pytest.mark.parametrize("weighted", [False, True])
def test_train_stream_tc_design_matches_plain(cuda, monkeypatch, weighted):
    """The tensor-core design (forced on a chain too small for the launch
    rule to take it): 4 epochs of batch 32 over 137 rows (a ragged last
    batch), with the guard, against the plain version at 1e-4; two
    launches give the same bits; two chunks of two epochs equal one launch
    bit for bit; the grid does not change the bits."""
    monkeypatch.setattr(STK, "uses_tc",
                        lambda sp, batchsize: STK.tc_reason(sp) is None)
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), (x, th), perms, \
        w = _tc_case(cuda)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, x, th)
    kw = dict(batchsize=32, guard_nonfinite=True, with_losses=True,
              w=w if weighted else None)
    before = STK.run_fused_train_stream.tc_launches
    got = STK.run_fused_train_stream(*head, perms, **kw)
    again = STK.run_fused_train_stream(*head, perms, **kw)
    three = STK.run_fused_train_stream(*head, perms, n_blocks=3, **kw)
    a = STK.run_fused_train_stream(*head, perms[:2], **kw)
    n_batches = -(-x.shape[0] // 32)
    b = STK.run_fused_train_stream(
        plan, a[0], masks, slots, cparams, a[1], a[2], x, th, perms[2:],
        count0=2 * n_batches - int(a[4].sum()), **kw)
    torch.cuda.synchronize()
    assert STK.run_fused_train_stream.tc_launches == before + 5
    want = STK.fused_train_stream_plain(*head, perms, **kw)
    for i in (0, 1, 2, 3):
        for u, v in zip(got[i], want[i]):
            torch.testing.assert_close(u, v, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[5], want[5], rtol=0, atol=1e-4)
    assert got[4].tolist() == want[4].tolist()
    assert _stream_bits_equal(got, again) and _stream_bits_equal(got, three)
    chained = (b[0], b[1], b[2], [torch.cat([u, v]) for u, v in
                                  zip(a[3], b[3])], None,
               torch.cat([a[5], b[5]]))
    assert _stream_bits_equal(got, chained)


def test_train_stream_tc_design_past_one_pass(cuda, monkeypatch):
    """Hidden layers of 300: the tensor-core design's tile products take two
    passes of output columns and its W items three blocks of input
    features. One Adam step on a batch of 96 against the plain version: the
    gradient (the first moment) to 1e-5 of its largest entry, parameters
    and loss at 1e-5. (Over 2 epochs Adam carries rounding into entries
    whose gradient is near zero: there the tile body and this design end
    8.8e-4 from the plain version alike, on an H100.)"""
    monkeypatch.setattr(STK, "uses_tc",
                        lambda sp, batchsize: STK.tc_reason(sp) is None)
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), (x, th), perms, \
        _w = _tc_case(cuda, d=6, n=2, hidden=300, blocks=1, rows=200,
                      epochs=1)
    zeros = [torch.zeros_like(p) for p in tparams]
    rows = perms[0, :96]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, x[rows],
            th[rows], np.arange(96)[None])
    before = STK.run_fused_train_stream.tc_launches
    got = STK.run_fused_train_stream(*head, batchsize=96, with_losses=True)
    want = STK.fused_train_stream_plain(*head, batchsize=96,
                                        with_losses=True)
    torch.cuda.synchronize()
    assert STK.run_fused_train_stream.tc_launches == before + 1
    for u, v in zip(got[1], want[1]):
        assert float((u - v).abs().max()) <= 1e-5 * float(v.abs().max())
    for u, v in zip(got[0], want[0]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-5)
    torch.testing.assert_close(got[5], want[5], rtol=0, atol=1e-5)


def _leaf_gap(got, want):
    """``perfbench/check.py``'s leaf number: the widest ``|‖a‖ − ‖r‖| /
    max(‖r‖, median leaf ‖r‖)`` over leaves whose reference is above a
    thousandth of the median leaf's."""
    na = [float(t.double().norm()) for t in got]
    nr = [float(t.double().norm()) for t in want]
    med = float(np.median(nr))
    return max(abs(a - r) / max(r, med) for a, r in zip(na, nr)
               if r > 1e-3 * med)


def test_train_stream_tc_design_at_the_cell_shape(cuda):
    """The benchmark's emulator32.train shape (d 32, n 8, 4 coupling blocks
    of hidden 256, batch 8192): the launch rule takes the tensor-core
    design; against the plain version within the cell's training limits
    (perfbench/limits/emulator32.train.json: the first step's gradient
    ``grad_gap`` 2.5e-5, the steps' change ``step_gap`` 1e-3, every step's
    loss 1e-5); two launches give the same bits, and two chunks equal one
    launch."""
    (plan, _tc, tparams, masks, slots, cparams, _f, _u), (x, th), perms, \
        _w = _tc_case(cuda, d=32, n=8, hidden=256, blocks=4, rows=3 * 8192,
                      epochs=2)
    sp = SK.StepPlan(plan, tparams, masks, slots, cparams, 32, 8, _tc)
    assert STK.launch_shape(sp, 8192).tc
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, x, th)
    kw = dict(batchsize=8192, with_losses=True, step_plan=sp)
    got = STK.run_fused_train_stream(*head, perms, **kw)
    again = STK.run_fused_train_stream(*head, perms, **kw)
    a = STK.run_fused_train_stream(*head, perms[:1], **kw)
    b = STK.run_fused_train_stream(plan, a[0], masks, slots, cparams, a[1],
                                   a[2], x, th, perms[1:], count0=3, **kw)
    rows = perms[0, :8192]
    one = (x[rows], th[rows], np.arange(8192)[None])   # the first step
    first = STK.run_fused_train_stream(*head[:7], *one, **kw)
    kw.pop("step_plan")
    want = STK.fused_train_stream_plain(*head, perms, **kw)
    want1 = STK.fused_train_stream_plain(*head[:7], *one, **kw)
    torch.cuda.synchronize()
    assert _leaf_gap(first[1], want1[1]) <= 2.5e-5      # mu = (1 - b1) g
    moved = [u - p for u, p in zip(got[0], tparams)]
    assert _leaf_gap(moved, [u - p for u, p in zip(want[0], tparams)]) <= 1e-3
    loss_gap = ((got[5] - want[5]).abs() / (1 + want[5].abs())).max()
    assert float(loss_gap) <= 1e-5
    assert _stream_bits_equal(got, again)
    chained = (b[0], b[1], b[2], [torch.cat([u, v]) for u, v in
                                  zip(a[3], b[3])], None,
               torch.cat([a[5], b[5]]))
    assert _stream_bits_equal(got, chained)


def test_train_fused_takes_the_stream_mode(cuda, monkeypatch):
    """With the resident budget failing, ``train`` on a CUDA flow runs
    ``train_stream`` once and no other training kernel."""
    def fails(packed):
        raise FT.UnsupportedFusedTrain("probe: force stream")

    monkeypatch.setattr(FT, "_check_budget", fails)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    th = rng.uniform(-1, 2, size=(500, 1)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device=cuda, hidden_dim_s=16, hidden_dim_t=16)
    flow = dt.Flow(dt.flow_chain(
        dt.coupling_layer(data, [0, 1, 2], **kw),
        dt.coupling_layer(data, [2, 3, 4], **kw),
        dt.normalization_layer(x, -1.0, 1.0, device=cuda)), data, device=cuda)
    before = (STK.run_fused_train_stream.launches, TK.run_fused_train.launches)
    state = dt.train(flow, data, epochs=3, batchsize=64, verbose=False)
    assert flow.trained_path == "fused" and flow.fused_kernel_mode == "stream"
    assert (STK.run_fused_train_stream.launches,
            TK.run_fused_train.launches) == (before[0] + 1, before[1])
    assert state.count == 3 * 8
    assert flow.train_loss[2] < flow.train_loss[0]


def _coupling_nets(device, kind, K=6, A=4, hidden=18, n_s=2, n_t=1,
                   act="gelu", bias=True):
    g = torch.Generator().manual_seed(5)

    def net(n_sub):
        dims = [K] + [hidden] * n_sub + [A]
        ws = [(torch.randn(a, b, generator=g) * (0.7 / a ** 0.5)).to(device)
              for a, b in zip(dims[:-1], dims[1:])]
        bs = ([(torch.randn(b, generator=g) * 0.1).to(device)
               for b in dims[1:]] if bias else [])
        return ws, bs, act

    return (net(n_s) if kind == "nvp" else None), net(n_t)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind", ["nvp", "nice"])
def test_coupling_kernels_match_plain(cuda, kind, direction):
    """1001 rows (a ragged last tile), hidden 18, n_s != n_t, a non-zero
    g_ldj: coupling_fwd and coupling_bwd against their plain versions at 1e-4
    (f32 FMA in another summation order); two launches give the same bits;
    the counters move by one per launch."""
    s, t = _coupling_nets(cuda, kind)
    g = torch.Generator().manual_seed(6)
    h, y, gy = (torch.randn(1001, w, generator=g).to(cuda) for w in (6, 4, 4))
    gl = torch.randn(1001, generator=g).to(cuda)
    before = CPK.launch_counts()
    out = CPK.coupling_fwd(s, t, h, y, direction=direction)
    back = CPK.coupling_bwd(s, t, h, y, gy, gl, direction=direction)
    again = CPK.coupling_bwd(s, t, h, y, gy, gl, direction=direction)
    torch.cuda.synchronize()
    after = CPK.launch_counts()
    assert after["coupling_fwd"] == before["coupling_fwd"] + 1
    assert after["coupling_bwd"] == before["coupling_bwd"] + 2
    assert after["coupling_bwd_reduce"] == before["coupling_bwd_reduce"] + 2
    want = CPK.coupling_fwd_plain(s, t, h, y, direction=direction,
                                  with_ldj=True)
    want_b = CPK.coupling_bwd_plain(s, t, h, y, gy, gl, direction=direction)

    def flat(o):
        return [o] if isinstance(o, torch.Tensor) else [
            x for p in o if p is not None for x in flat(p)]

    for a, b in zip(flat(out) + flat(back), flat(want) + flat(want_b)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for a, b in zip(flat(back), flat(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["auto", False, True])
def test_layers_launch_the_coupling_kernels_only_under_true(cuda, mode):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 5, generator=g).to(cuda)
    th = torch.rand(300, 1, generator=g).to(cuda)
    dt.set_fused_kernels(mode)
    try:
        for kind in (dt.RNVPCouplingLayer, dt.NICECouplingLayer):
            layer = dt.coupling_layer(5, [0, 1, 2], n=1, kind=kind,
                                      generator=g, device=cuda,
                                      hidden_dim_s=16, hidden_dim_t=16,
                                      zero_init_final=False)
            before = CPK.launch_counts()
            z, ldj = layer.inverse(x, th)
            layer.forward(z, th)
            layer.forward_(z, th)
            fwd = CPK.launch_counts()
            ((z ** 2).sum() - ldj.sum()).backward()
            torch.cuda.synchronize()
            bwd = CPK.launch_counts()
            on = mode is True
            assert fwd["coupling_fwd"] - before["coupling_fwd"] == 3 * on
            assert bwd["coupling_bwd"] - before["coupling_bwd"] == on
            assert all(p.grad is not None for p in layer.parameters())
    finally:
        dt.set_fused_kernels("auto")
