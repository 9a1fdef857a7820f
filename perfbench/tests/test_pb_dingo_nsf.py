"""The ``dingo_nsf`` kind on the CPU at a small size (d 5, a 6-wide
context, 3 steps, residual conditioners of 2 blocks of 16, 4 bins): the
kind and its reference are found by the configuration's name, the
reference's leaves are the port's, a whole run of ``dingo_nsf15.train``
comes out correct under the cell's own limits, and with the timed path
broken underneath (a state returned unchanged, half of each batch left out)
it does not."""

import time

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from perfbench import kinds, reference
from perfbench.inputs import Problem, draw_weights
from perfbench.run import execute

CELL = "dingo_nsf15.train"
D, N = 5, 6
_RNG = np.random.default_rng(5)
SMALL = {"config": {
    "d": D, "n_cond": N, "num_flow_steps": 3, "hidden_dim": 16,
    "num_transform_blocks": 2, "num_bins": 4,
    "permutations": [_RNG.permutation(D).tolist() for _ in range(4)],
    "theta_box": {"lo": [-1.0] * N, "hi": [1.0] * N},
    "train": {"rows": 2000, "batchsize": 256, "f_training": 0.9,
              "f_validation": 0.1}}}


def _small_cfg(manifest):
    cfg = manifest.config(manifest.cell(CELL)["config"])
    cfg.update(SMALL["config"])
    return cfg


def test_kind_and_reference_found_by_name(manifest):
    cfg = manifest.config(manifest.cell(CELL)["config"])
    assert cfg["kind"] == "dingo_nsf"
    assert kinds.module(cfg).__name__.endswith("kinds.dingo_nsf")
    assert reference.module(cfg).__name__.endswith("reference.dingo_nsf")
    assert len(cfg["permutations"]) == cfg["num_flow_steps"] + 1
    assert all(sorted(p) == list(range(cfg["d"]))
               for p in cfg["permutations"])


def test_param_layout_is_the_ports_leaves(manifest):
    cfg = _small_cfg(manifest)
    problem = Problem(cfg, 11, "cpu")
    _, leaves = draw_weights(cfg, 11, "cpu")
    flow = kinds.module(cfg).build(cfg, leaves, problem, "cpu")
    port = kinds.module(cfg).leaves(cfg, flow)
    layout = reference.module(cfg).param_layout(cfg)
    assert set(port) == {name for name, _, _ in layout}
    for name, shape, _ in layout:
        assert tuple(port[name].shape) == shape, name
        assert torch.equal(port[name].detach(), leaves[name]), name
    from densityflows_tpu_torch.models.fused_train import trainable_leaves

    assert {id(p) for p in trainable_leaves(flow.model)} == {
        id(p) for p in port.values()}


def _run(manifest):
    return execute(manifest, CELL, 2**31 + 91, 0.1, False, "cpu",
                   time.time(), overrides=SMALL)


def test_sound_run_is_correct(manifest):
    line = _run(manifest)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"loss_gap", "epoch_loss_gap", "grad_gap",
                                   "step_gap"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_are_not_correct(manifest, monkeypatch, fault):
    real = dt.train

    def unchanged(flow, data, optimizer=None, opt_state=None, **kw):
        before = [p.detach().clone() for p in flow.model.parameters()]
        new = real(flow, data, optimizer, opt_state, **kw)
        with torch.no_grad():
            for p, b in zip(flow.model.parameters(), before):
                p.copy_(b)
        if opt_state is None:
            opt_state = dt.AdamState(0, [torch.zeros_like(m) for m in new.mu],
                                     [torch.zeros_like(v) for v in new.nu])
        return opt_state

    def half_batch(flow, data, optimizer=None, opt_state=None, **kw):
        tr = np.asarray(data.partition.training)
        part = dt.DataPartition(tr[: max(1, len(tr) // 2)],
                                data.partition.validation,
                                data.partition.testing)
        return real(flow, dt.DataArrays(data.x, data.theta, part), optimizer,
                    opt_state, **kw)

    monkeypatch.setattr(dt, "train", {"unchanged": unchanged,
                                      "half_batch": half_batch}[fault])
    line = _run(manifest)
    assert not line["correct"], line["checks"]
