"""The plain reference against the program's CPU path at a tiny size, and
the rewritten Philox draw against the program's own numpy model of it."""

import numpy as np
import pytest
import torch

from perfbench import system
from perfbench.check import row_gap
from perfbench.inputs import Problem, draw_weights
from perfbench.reference.realnvp_flow import Reference
from perfbench.reference.philox import normal_draw, seed_from_generator_seed
from perfbench.reference.train import replay

TINY = {
    "name": "tiny", "kind": "realnvp_flow", "dtype": "float32",
    "d": 6, "n_cond": 2, "hidden": 8, "n_sublayers": 2, "activation": "relu",
    "couplings": [{"transform": [3, 4, 5]}, {"transform": [0, 1, 2]},
                  {"transform": [5, 0, 2]}, {"transform": [1, 3, 4]}],
    "normalization": {"alpha": -1.0, "beta": 1.0, "rows": 512},
    "theta_box": {"lo": [-1.0, 0.0], "hi": [2.0, 5.0]},
    "data": {"kind": "simulator", "width": 16, "noise": 0.1},
    "weights": {"init": "glorot_uniform", "final_scale": 0.5,
                "bias_scale": 0.1},
    "optimizer": {"name": "adam", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                  "eps": 1e-8},
    "train": {"rows": 2048, "batchsize": 128, "f_training": 0.9,
              "f_validation": 0.1},
}


@pytest.mark.parametrize("blocks", [False, True])
def test_log_prob_and_sampling_map(blocks):
    cfg = dict(TINY, blocks=blocks)
    if blocks:
        # a block's second layer is the complement of its first
        cfg["couplings"] = [{"transform": [3, 4, 5]}, {"transform": [0, 1, 2]},
                            {"transform": [0, 2, 5]}, {"transform": [1, 3, 4]}]
    prob = Problem(cfg, 7, "cpu")
    _, leaves = draw_weights(cfg, 7, "cpu")
    flow = system.build_flow(cfg, leaves, prob, "cpu")
    ref = Reference(cfg, leaves, prob.norm_x, prob.theta_lo, prob.theta_hi)
    x, th = prob.rows(300, "q")
    with torch.no_grad():
        assert row_gap(flow.log_prob(x, th), ref.log_prob(x, th)) < 1e-5
        z = torch.randn(300, 6, generator=torch.Generator().manual_seed(1))
        thn = ref.normalize_theta(th)
        assert row_gap(flow.model.forward_(z, thn), ref.sample(z, th)) < 1e-5
        # a wrong weight is seen
        leaves2 = {k: v.clone() for k, v in leaves.items()}
        leaves2["c1.t.b0"] += 0.01
        bad = Reference(cfg, leaves2, prob.norm_x, prob.theta_lo, prob.theta_hi)
        assert row_gap(flow.log_prob(x, th), bad.log_prob(x, th)) > 1e-4


@pytest.mark.parametrize("fits", [False, True])
def test_training_replay_matches_the_plain_program(fits):
    """The checked calls (one step, then two epochs over two full batches
    and a partial one, shuffled by the program under ``fits``) on the
    program's plain path against the reference's replay of them."""
    from perfbench.generators.train import (
        PortTrainer, check_readings, checked_calls, train_gaps)

    cfg = dict(TINY, blocks=False)
    prob = Problem(cfg, 11, "cpu")
    x, th = prob.rows(2048, "train")
    tr, va = prob.split(2048)
    _, leaves = draw_weights(cfg, 11, "cpu")
    p0 = {k: v.clone() for k, v in leaves.items()}
    traffic = {"fits": fits, "epochs": 1, "check": {"batches": 2,
                                                    "epochs": 2},
               "trace_calls": 1}
    calls = checked_calls(cfg, traffic, 11, tr)
    # 1843 training rows: 14 batches of 128 and a last one of 51
    assert [len(c["idx"]) for c in calls] == [128, 2 * 128 + 51]
    assert len(np.intersect1d(calls[0]["idx"], calls[1]["idx"])) == 0
    assert [c["reset"] for c in calls] == [fits, fits]
    trainer = PortTrainer(cfg, leaves, prob, "cpu", x.numpy(), th.numpy())
    readings = check_readings(trainer, calls, p0, va, 128)
    ref = replay(cfg, p0, prob.norm_x, prob.theta_lo, prob.theta_hi, x, th,
                 calls, va)
    assert [len(c) for c in readings["losses"]] == [1, 2]
    gaps = train_gaps(calls, cfg, readings, ref, p0)
    assert set(gaps) == {"loss_gap", "epoch_loss_gap", "grad_gap",
                         "step_gap"}
    assert max(gaps.values()) < 1e-5, gaps
    # the same calls without the partial batch, or in another order, differ
    for change in ("partial", "order"):
        other = [dict(c) for c in calls]
        if change == "partial":
            other[1]["idx"] = other[1]["idx"][:256]
        elif fits:
            other[1]["gen_seed"] += 1
        else:
            other[1]["idx"] = other[1]["idx"][::-1].copy()
        off = train_gaps(calls, cfg, readings, replay(
            cfg, p0, prob.norm_x, prob.theta_lo, prob.theta_hi, x, th, other,
            va), p0)
        assert off["epoch_loss_gap"] > 3e-5 and off["step_gap"] > 1e-3, (
            change, off)


def test_philox_matches_the_programs_model():
    from densityflows_tpu_torch.ops.chain_kernels import (
        _seed_from, philox_normal_reference)

    gen_seed = 2**31 + 99
    seed = seed_from_generator_seed(gen_seed)
    assert seed == _seed_from(torch.Generator().manual_seed(gen_seed))
    ours = normal_draw(seed, 257, 7, "cpu", row_offset=5).numpy()
    theirs = philox_normal_reference(seed, 257, 7, row_offset=5)
    np.testing.assert_allclose(ours, theirs, rtol=2e-6, atol=2e-6)
    assert abs(float(ours.mean())) < 0.2 and 0.8 < float(ours.std()) < 1.2
