"""Dingo's neural spline flow on the port, against the benchmark's plain
reference (``perfbench/reference/dingo_nsf.py``) at a small size on the CPU:
d 5, a 6-wide context, 3 steps, residual conditioners of 2 blocks of 16,
4 bins, seeded random weights (the benchmark's draw). The flow is built by
the benchmark's kind (``perfbench/kinds/dingo_nsf.py``) through the port's
public constructors.

Tolerances: float32 on both sides with the same products in another order
(the port multiplies by L·U once, the reference by U then L; batch norm by
``F.batch_norm`` against the written formula), so values agree to a few
float32 roundings of their size: 1e-5 relative.
"""

import copy
import os
import types

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_chain as FC
from densityflows_tpu_torch.models.fused_train import (
    UnsupportedFusedTrain, trainable_leaves)
from densityflows_tpu_torch.ops import chain_kernels as CK
from densityflows_tpu_torch.ops.mlp import BatchNorm, batch_statistics
from perfbench.check import leaf_gap, moved_leaves
from perfbench.inputs import draw_weights
from perfbench.kinds import dingo_nsf as kind
from perfbench.reference import dingo_nsf as ref_mod
from perfbench.reference.train import replay

import _torch_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N = 5, 6
RTOL = 1e-5


def _cfg(seed=0, batch_norm=True):
    import json

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "dingo_nsf15.json")) as f:
        cfg = json.load(f)
    rng = np.random.default_rng(seed)
    cfg.update({"d": D, "n_cond": N, "num_flow_steps": 3, "hidden_dim": 16,
                "num_transform_blocks": 2, "num_bins": 4,
                "batch_norm": batch_norm,
                "permutations": [rng.permutation(D).tolist()
                                 for _ in range(4)],
                "theta_box": {"lo": [-1.0] * N, "hi": [1.0] * N}})
    return cfg


def _problem():
    return types.SimpleNamespace(theta_lo=-torch.ones(N),
                                 theta_hi=torch.ones(N))


def _pair(seed=0, batch_norm=True):
    """The port's flow and the reference, on the same seeded weights."""
    cfg = _cfg(seed, batch_norm)
    _, leaves = draw_weights(cfg, 1000 + seed, "cpu")
    params = {k: v.clone() for k, v in leaves.items()}
    flow = kind.build(cfg, leaves, _problem(), "cpu")
    p = _problem()
    ref = ref_mod.Reference(cfg, params, None, p.theta_lo, p.theta_hi)
    return cfg, flow, ref, params


def _rows(rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = 1.2 * torch.randn(rows, D, generator=g)
    th = 2.0 * torch.rand(rows, N, generator=g) - 1.0
    return x, th


def _close(a, r, rtol=RTOL):
    a, r = a.detach().double(), r.detach().double()
    return float(((a - r).abs() / (1.0 + r.abs())).max()) < rtol


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("batch_norm", [True, False])
def test_log_prob_matches_the_reference(seed, batch_norm):
    _, flow, ref, _ = _pair(seed, batch_norm)
    x, th = _rows(257, seed)
    with torch.no_grad():
        assert _close(flow.log_prob(x, th), ref.log_prob(x, th))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_round_trip(seed):
    """The port's draw is the reference's map of the same base draw, and
    ``log_prob`` of it inverts it: z back, the same density."""
    _, flow, ref, _ = _pair(seed)
    _, th = _rows(64, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        xs = flow.sample((64,), th, generator=gen)
        z = flow.base.sample(torch.Generator().manual_seed(seed), (64,),
                             "cpu")
        assert _close(xs, ref.sample(z, th), 1e-4)
        z_back, _ = flow.inverse(xs, th)
        assert _close(z_back, z, 1e-4)
        assert _close(flow.log_prob(xs, th), ref.log_prob(xs, th))


@pytest.mark.parametrize("seed", [0, 1])
def test_nll_gradients_per_leaf(seed):
    """The train-mode NLL's gradient of every leaf (the names of the
    reference's ``param_layout``) by the worst leaf's norm gap."""
    cfg, flow, ref, params = _pair(seed)
    x, th = _rows(200, seed)
    named = kind.leaves(cfg, flow)
    assert set(named) == {n for n, _, _ in ref_mod.param_layout(cfg)}
    with batch_statistics(flow.model):
        loss = dt.masked_nll_loss(flow.model, flow.base, x,
                                  flow.prepare_theta(th, (200,)),
                                  torch.ones(200))
    grads = torch.autograd.grad(loss, [named[k] for k in named])
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    ref.p = leaves
    ref_loss = ref.nll(x, th)
    ref_grads = torch.autograd.grad(ref_loss, [leaves[k] for k in named])
    assert _close(loss, ref_loss)
    norms = sorted(float(g.norm()) for g in ref_grads)
    med = norms[len(norms) // 2]
    for k, g, r in zip(named, grads, ref_grads):
        # the bias before a batch norm in train mode has no gradient but
        # round-off: compare the others
        if float(r.norm()) < 1e-3 * med:
            continue
        gap = abs(float(g.norm()) - float(r.norm())) / max(float(r.norm()),
                                                          med)
        assert gap < 1e-4, k


def test_batch_norm_modes_and_running_statistics():
    """Eval mode outside ``batch_statistics``; inside it the batch's own
    statistics, the running ones moved as the reference moves them; eval
    densities after that with the moved statistics."""
    _, flow, ref, _ = _pair(0)
    norms = [m for m in flow.model.modules() if isinstance(m, BatchNorm)]
    assert norms and not any(m.training for m in norms)
    x, th = _rows(300, 3)
    before = [m.running_mean.clone() for m in norms]
    with torch.no_grad():
        flow.log_prob(x, th)
    assert all(torch.equal(a, m.running_mean) for a, m in zip(before, norms))
    with batch_statistics(flow.model), torch.no_grad():
        assert all(m.training for m in norms)
        lp = flow.log_prob(x, th)
        ref_lp = ref._log_prob(x, th, True)
    assert not any(m.training for m in norms)
    assert _close(lp, ref_lp)
    port_stats = [(m.running_mean, m.running_var) for m in norms]
    # the port's chain lists couplings noise → data; the reference's
    # statistics are keyed by step, data → noise
    ref_stats = [ref.running[k] for k in sorted(
        ref.running, key=lambda k: (-int(k.split(".")[0][1:]), k))]
    assert len(port_stats) == len(ref_stats)
    for (pm, pv), (rm, rv) in zip(port_stats, ref_stats):
        assert not torch.equal(pm, torch.zeros_like(pm))
        assert _close(pm, rm) and _close(pv, rv)
    with torch.no_grad():
        assert _close(flow.log_prob(x, th), ref.log_prob(x, th))


@pytest.mark.parametrize("rows", [512, 3 * 128 + 37])
def test_two_epoch_train_matches_the_replay(rows):
    """``train()`` (the plain program, shuffled) against
    ``reference/train.replay`` of the same call: every epoch's NLLs and the
    weights after it. With 421 rows at batch 128 the last batch of each
    epoch holds 37 rows: the program hands it unpadded to the batch norms."""
    cfg, flow, _, params = _pair(2)
    cfg["train"] = {"batchsize": 128}
    x, th = _rows(rows + 64, 4)
    tr, va = np.arange(rows), np.arange(rows, rows + 64)
    data = dt.DataArrays(x.numpy(), th.numpy(),
                         dt.DataPartition(tr, va, np.zeros(0, np.int64)))
    opt = cfg["optimizer"]
    dt.train(flow, data, dt.adam(opt["lr"], opt["b1"], opt["b2"],
                                 opt["eps"]),
             epochs=2, batchsize=128, verbose=False,
             generator=torch.Generator().manual_seed(7))
    assert flow.trained_path == "torch"
    p = _problem()
    out = replay(cfg, params, None, p.theta_lo, p.theta_hi, x, th,
                 [{"idx": tr, "epochs": 2, "gen_seed": 7, "reset": False}],
                 va)
    for (tl, vl), (rt, rv) in zip(zip(flow.train_loss, flow.valid_loss),
                                  out["losses"][0]):
        assert abs(tl - rt) / (1 + abs(rt)) < RTOL
        assert abs(vl - rv) / (1 + abs(rv)) < RTOL
    named = kind.leaves(cfg, flow)
    # the benchmark's step_gap: each leaf's change by its norm, the leaves
    # whose first gradient is round-off (a bias before a batch norm in
    # train mode, which Adam scales to full steps) left out; Adam's first
    # steps are about ±lr an element whatever the gradient's size, so the
    # round-off of small gradients shows in them: 1e-3
    names = moved_leaves(out["grad1"])
    gap = leaf_gap({k: named[k].detach() - params[k] for k in names},
                   {k: out["params"][0][k] - params[k] for k in names},
                   names)
    assert gap < 1e-3


def test_partial_batch_is_unpadded_for_batch_norm(monkeypatch):
    """The plain program's last batch of an epoch has the real rows only
    when the model holds batch norm, and is padded to the batch otherwise."""
    import densityflows_tpu_torch.train as _  # noqa: F401
    import sys

    T = sys.modules["densityflows_tpu_torch.train"]
    seen = []
    real = T._loss_and_grads

    def spy(model, base, x, theta, mask, *a, **kw):
        seen.append((x.shape[0], float(mask.sum())))
        return real(model, base, x, theta, mask, *a, **kw)

    monkeypatch.setattr(T, "_loss_and_grads", spy)
    for batch_norm, last in ((True, (37, 37.0)), (False, (128, 37.0))):
        cfg, flow, _, _ = _pair(0, batch_norm)
        x, th = _rows(165 + 20, 5)
        data = dt.DataArrays(x.numpy(), th.numpy(), dt.DataPartition(
            np.arange(165), np.arange(165, 185), np.zeros(0, np.int64)))
        seen.clear()
        dt.train(flow, data, epochs=1, batchsize=128, verbose=False,
                 shuffle=False)
        assert seen == [(128, 128.0), last]


def test_train_routes_to_the_plain_program():
    """The whole-run kernels decline the chain by name; the plain program
    trains it, and the Adam state holds every parameter (γ and β
    included) and no running statistic."""
    cfg, flow, _, _ = _pair(0)
    x, th = _rows(100, 6)
    data = dt.DataArrays.make(x.numpy(), th.numpy(), rng=0)
    with pytest.raises(UnsupportedFusedTrain, match="RQSCouplingLayer"):
        dt.train(flow, data, epochs=1, batchsize=32, verbose=False,
                 fused_kernel=True)
    state = dt.train(flow, data, epochs=1, batchsize=32, verbose=False)
    assert flow.trained_path == "torch"
    leaves = trainable_leaves(flow.model)
    assert len(state.mu) == len(leaves) == len(ref_mod.param_layout(cfg))
    assert {id(p) for p in leaves} == {
        id(p) for p in kind.leaves(cfg, flow).values()}
    buffers = {id(b) for b in flow.model.buffers()}
    assert buffers and not buffers & {id(p) for p in leaves}


@pytest.mark.parametrize("option", ["remat", "mesh"])
def test_batch_norm_refuses_remat_and_mesh(option):
    _, flow, _, _ = _pair(0)
    x, th = _rows(100, 6)
    data = dt.DataArrays.make(x.numpy(), th.numpy(), rng=0)
    kw = {"remat": True} if option == "remat" else {"mesh": dt.make_mesh()}
    with pytest.raises(ValueError, match="batch norm"):
        dt.train(flow, data, epochs=1, batchsize=32, verbose=False, **kw)


def test_save_flow_refuses_before_writing(tmp_path):
    _, flow, _, _ = _pair(0)
    for save in (lambda p: dt.save_flow(p, flow),
                 lambda p: dt.save_element(p, flow.model)):
        target = str(tmp_path / "ckpt")
        with pytest.raises(NotImplementedError, match="LULinearLayer"):
            save(target)
        assert not os.path.exists(target)


@pytest.mark.parametrize("dirn", ["inv", "fwd"])
def test_lu_layer_is_declined_by_the_chain_plan(dirn):
    """An LU layer (with its bias) in a RealNVP chain is outside the chain
    kernels' plan: the chain is not fusable, the plan names the layer, and
    the chain runs on its per-layer path (LU's map and ldj)."""
    g = torch.Generator().manual_seed(3)
    lu = dt.lu_linear_layer(D, device="cpu")
    with torch.no_grad():
        for p in (lu.lower, lu.upper, lu.unconstrained_diag, lu.bias):
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    kw = dict(n=N, hidden_dim_s=8, hidden_dim_t=8, zero_init_final=False,
              generator=g, device="cpu")
    chain = dt.flow_chain(dt.coupling_layer(D, [0, 2], **kw), lu,
                          dt.permutation_layer([4, 2, 0, 1, 3]),
                          dt.coupling_layer(D, [1, 3, 4], **kw))
    assert not FC.chain_is_fusable(chain, D, N)
    with pytest.raises(FC._Unsupported, match="LULinearLayer is outside"):
        FC._plan_params(chain, dirn)
    x, th = _rows(70, 8)
    th = (th + 1) / 2
    assert FC.maybe_apply_fused(chain, x, th, dirn, True) is None
    with torch.no_grad():
        y, ldj = lu.inverse(x) if dirn == "inv" else lu.forward(x)
        w = lu.weight()
        want = (x @ w.T + lu.bias if dirn == "inv"
                else torch.linalg.solve(w, (x - lu.bias).T).T)
        logdet = torch.linalg.slogdet(w)[1]
    assert _close(y, want, 1e-4)
    assert _close(ldj, (logdet if dirn == "inv" else -logdet).expand(70),
                  1e-5)


def test_spline_chain_is_declined_by_the_chain_kernels():
    cfg, flow, _, _ = _pair(0)
    assert not FC.chain_is_fusable(flow.model, D, N)
    assert FC.maybe_apply_fused(flow.model, *_rows(4), "inv", True) is None
    lu_only = dt.flow_chain(copy.deepcopy(flow.model.layers[0]))
    assert not FC.chain_is_fusable(lu_only, D, N)


def test_graphed_adam_update_is_adam_update():
    """The update the graphed steps replay (``Adam._step`` with the bias
    corrections as device scalars, written back to the moments) gives the
    bits of ``Adam.update`` plus the add, over a few steps on the CPU (the
    graphs themselves run only on a card)."""
    import sys

    T = sys.modules["densityflows_tpu_torch.train"]
    opt = dt.adam(1e-4)
    g = torch.Generator().manual_seed(9)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [torch.randn(s, generator=g) for s in shapes]
    mine = [p.clone() for p in params]
    state = opt.init(params)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for count in range(1, 4):
        grads = [torch.randn(s, generator=g) for s in shapes]
        updates, state = opt.update(grads, state, params)
        torch._foreach_add_(params, list(updates))
        bc = [torch.tensor(v) for v in T._bias_corrections(opt.b1, opt.b2,
                                                          count)]
        steps, new_mu, new_nu = opt._step(grads, mu, nu, *bc)
        torch._foreach_copy_(mu, new_mu)
        torch._foreach_copy_(nu, new_nu)
        torch._foreach_add_(mine, steps)
    for a, b in zip(mine + mu + nu, params + state.mu + state.nu):
        assert torch.equal(a, b)


def test_graphs_are_declined_by_reason():
    _, flow, _, _ = _pair(0)
    import sys

    T = sys.modules["densityflows_tpu_torch.train"]
    assert T._graph_reason(flow.model, flow.base, dt.adam(1e-3)) is None
    assert "optimizer" in T._graph_reason(flow.model, flow.base,
                                          type("Sgd", (), {})())
    mlp_flow = dt.Flow(dt.flow_chain(dt.maf_layer(D, n=N, device="cpu")),
                       dt.MetaData("", D, N, np.zeros(N), np.ones(N)),
                       device="cpu")
    assert "graph-safe" in T._graph_reason(mlp_flow.model, mlp_flow.base,
                                           dt.adam(1e-3))
    rnvp = dt.flow_chain(dt.coupling_layer(D, [0, 2], n=N, hidden_dim_s=8,
                                           hidden_dim_t=8, device="cpu"))
    assert "no spline coupling" in T._graph_reason(rnvp, flow.base,
                                                   dt.adam(1e-3))


def test_port_and_reference_agree_bit_for_bit():
    """The port runs nflows' arithmetic op for op as the reference writes
    it (LU as two products, ``F.batch_norm``, nflows' spline), so densities
    and the train-mode NLL's gradients agree to the bit: a difference in
    either shows alone, not hidden in round-off that the ill-conditioned
    gradients of a contracting chain would amplify."""
    cfg, flow, ref, params = _pair(3)
    x, th = _rows(128, 3)
    with torch.no_grad():
        assert torch.equal(flow.log_prob(x, th), ref.log_prob(x, th))
    named = kind.leaves(cfg, flow)
    with batch_statistics(flow.model):
        loss = dt.masked_nll_loss(flow.model, flow.base, x,
                                  flow.prepare_theta(th, (128,)),
                                  torch.ones(128))
    grads = torch.autograd.grad(loss, [named[k] for k in named])
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    ref.p = leaves
    ref_grads = torch.autograd.grad(ref.nll(x, th),
                                    [leaves[k] for k in named])
    for k, g, r in zip(named, grads, ref_grads):
        assert torch.equal(g, r), k
