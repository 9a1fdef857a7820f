"""The plain program's graphed steps against its eager steps on the card.

``train()`` replays a step from CUDA graphs (``train.py::_GraphedSteps``)
where ``_graph_reason`` allows it; these tests run two continued calls of
the same flow, from the same weights, rows and batch order, once graphed and
once eagerly, and hold the histories, the leaves, Adam's moments and batch
norm's running statistics to the limits the benchmark's training cells set
(``perfbench/limits/dingo_nsf15.train.json``). The chains: Dingo's spline
flow at a small size and a spline chain with MLP conditioners and no buffer
(both graphed by default), and a RealNVP chain with ActNorm and a
normalization layer (graphed here by hand, as the graphs are built for every
layer type ``_graph_reason`` lists).

    python -m pytest tests/test_torch_graphed_steps.py -m gpu -q
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops.mlp import batch_statistics
from perfbench.check import leaf_gap, moved_leaves, scalar_gap
from perfbench.inputs import draw_weights
from perfbench.kinds import dingo_nsf as kind

import _torch_cpu  # noqa: F401

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = sys.modules["densityflows_tpu_torch.train"]
D, N = 5, 6
ROWS, VALID, BATCH = 3 * 128 + 37, 64, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _limits():
    with open(os.path.join(ROOT, "perfbench", "limits",
                           "dingo_nsf15.train.json")) as f:
        return json.load(f)


def _dingo(device):
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "dingo_nsf15.json")) as f:
        cfg = json.load(f)
    rng = np.random.default_rng(0)
    cfg.update({"d": D, "n_cond": N, "num_flow_steps": 3, "hidden_dim": 16,
                "num_transform_blocks": 2, "num_bins": 4,
                "permutations": [rng.permutation(D).tolist()
                                 for _ in range(4)],
                "theta_box": {"lo": [-1.0] * N, "hi": [1.0] * N}})
    _, leaves = draw_weights(cfg, 1234, device)
    problem = types.SimpleNamespace(theta_lo=-torch.ones(N, device=device),
                                    theta_hi=torch.ones(N, device=device))
    return kind.build(cfg, leaves, problem, device)


def _rnvp(device, x):
    g = torch.Generator(device=device).manual_seed(5)
    kw = dict(n=N, hidden_dim_s=16, hidden_dim_t=16, zero_init_final=False,
              generator=g, device=device)
    chain = dt.flow_chain(dt.coupling_layer(D, [0, 2], **kw),
                          dt.actnorm_layer(x, device=device),
                          dt.permutation_layer([4, 2, 0, 1, 3]),
                          dt.coupling_layer(D, [1, 3, 4], **kw),
                          dt.normalization_layer(x, -3.0, 3.0,
                                                 device=device))
    meta = dt.MetaData("", D, N, -np.ones(N), np.ones(N))
    return dt.Flow(chain, meta, device=device)


def _spline(device):
    """A spline chain with MLP conditioners: no buffer to restore."""
    g = torch.Generator(device=device).manual_seed(6)
    kw = dict(kind=dt.RQSCouplingLayer, n=N, hidden_dim_t=16,
              zero_init_final=False, generator=g, device=device)
    chain = dt.flow_chain(dt.coupling_layer(D, [0, 2], **kw),
                          dt.permutation_layer([4, 2, 0, 1, 3]),
                          dt.coupling_layer(D, [1, 3, 4], **kw))
    meta = dt.MetaData("", D, N, -np.ones(N), np.ones(N))
    return dt.Flow(chain, meta, device=device)


def _data():
    g = torch.Generator().manual_seed(4)
    x = 1.2 * torch.randn(ROWS + VALID, D, generator=g)
    th = 2.0 * torch.rand(ROWS + VALID, N, generator=g) - 1.0
    part = dt.DataPartition(np.arange(ROWS), np.arange(ROWS, ROWS + VALID),
                            np.zeros(0, np.int64))
    return dt.DataArrays(x.numpy(), th.numpy(), part)


def _fit(make, graphed, monkeypatch):
    """Two continued ``train()`` calls, graphed or eager, on the same
    weights, rows and batch orders: ``(flow, state)``."""
    flow = make()
    with monkeypatch.context() as m:
        if graphed:
            m.setattr(T, "_graph_reason", lambda *a: None)
        else:
            m.setattr(T, "_graph_reason", lambda *a: "eager, for the test")
        opt, state = dt.adam(1e-3), None
        for call in range(2):
            state = dt.train(flow, _data(), opt, state, epochs=2,
                             batchsize=BATCH, verbose=False,
                             fused_kernel=False,
                             generator=torch.Generator().manual_seed(call))
    cache = flow.model.__dict__.get("_graph_cache") or {}
    assert ("steps" in cache) == graphed
    torch.cuda.synchronize()
    return flow, state


def _moved(make):
    """The leaves a first gradient moves, as the benchmark's ``step_gap``
    picks them: a bias before a batch norm in train mode has a round-off
    gradient only, whose sign Adam turns into a full step."""
    flow, data = make(), _data()
    x = torch.as_tensor(data.x[:BATCH], device=flow.device)
    th = flow.prepare_theta(torch.as_tensor(data.theta[:BATCH],
                                            device=flow.device), (BATCH,))
    leaves = trainable_leaves(flow.model)
    with batch_statistics(flow.model):
        loss = dt.masked_nll_loss(flow.model, flow.base, x, th,
                                  torch.ones(BATCH, device=flow.device))
    grads = torch.autograd.grad(loss, leaves)
    return moved_leaves({str(i): g for i, g in enumerate(grads)})


@pytest.mark.parametrize("chain", ["dingo", "spline", "rnvp"])
def test_graphed_steps_match_the_eager_steps(cuda, chain, monkeypatch):
    x0 = _data().x[:256]
    make = {"dingo": lambda: _dingo(cuda), "spline": lambda: _spline(cuda),
            "rnvp": lambda: _rnvp(cuda, x0)}[chain]
    if chain != "rnvp":
        flow = make()
        assert T._graph_reason(flow.model, flow.base, dt.adam(1e-3)) is None
    got, got_state = _fit(make, True, monkeypatch)
    want, want_state = _fit(make, False, monkeypatch)
    limits = _limits()
    assert len(got.train_loss) == len(want.train_loss) == 4
    for a, b in zip(got.train_loss + got.valid_loss,
                    want.train_loss + want.valid_loss):
        assert scalar_gap(a, b) <= limits["epoch_loss_gap"], (a, b)
    init = {str(i): p.detach() for i, p in
            enumerate(trainable_leaves(make().model))}
    names = _moved(make)
    for side in ("leaves", "mu", "nu"):
        if side == "leaves":
            a, b = (trainable_leaves(f.model) for f in (got, want))
            a = {k: p.detach() - init[k] for k, p in zip(init, a)}
            b = {k: p.detach() - init[k] for k, p in zip(init, b)}
        else:
            a = dict(zip(init, getattr(got_state, side)))
            b = dict(zip(init, getattr(want_state, side)))
        assert leaf_gap(a, b, names) <= limits["step_gap"], side
    assert got_state.count == want_state.count == 16
    # a bias before a train-mode norm moves by at most ~lr a step, and
    # its steps differ between any two runs
    _same_statistics(got.model, want.model, drift=2 * 1e-3 * 16)


def _same_statistics(got, want, drift):
    """Batch norm's running statistics within a thousandth of their scale,
    the scale at which the moved leaves agree, but a second norm's running
    mean: it carries the bias before it, which moves by round-off alone, so
    it may differ by the ``drift`` that bias can make. Every other buffer to
    float32 round-off."""
    from densityflows_tpu_torch.ops.mlp import ResidualBlock

    seen = set()
    for a, b in zip(got.modules(), want.modules()):
        if not isinstance(a, ResidualBlock):
            continue
        for k, (na, nb) in enumerate(zip(a.norms, b.norms)):
            seen.update((id(na.running_mean), id(na.running_var)))
            assert torch.allclose(na.running_var, nb.running_var,
                                  rtol=1e-3, atol=1e-3)
            gap = (na.running_mean - nb.running_mean).abs()
            assert float(gap.max()) <= (drift if k == 1 else 1e-3) + \
                1e-3 * float(nb.running_mean.abs().max())
    for a, b in zip(got.buffers(), want.buffers()):
        if id(a) not in seen:
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
