"""The rest of a run, with the timed path broken underneath, comes out not
correct: once for each fault a cell can have. The look for a card is
skipped (the program runs its CPU path at small sizes); the limits are the
cells' own.

- an answer altered where it is produced (serving cells);
- a step that returns its state unchanged (training cells);
- half of the batch left out, the mean taken over the rest (training);
- the last, partial batch of an epoch left out (training).

No cell spans chips, so no exchange between chips can be left out.
"""

import copy
import time

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models.flow import Flow
from perfbench.run import execute

SERVE = {
    "emulator32.serve": {"traffic": {"mix": {"log_prob": 1},
                                     "rows_log2": [3, 8], "pool_rows": 2048,
                                     "check_every": 2}},
}
TRAIN = {
    "quickstart5.train": {"config": {"train": {
        "rows": 1000, "batchsize": 64, "epochs": 2, "f_training": 0.9,
        "f_validation": 0.1}}},
    "emulator32.train": {"config": {"train": {
        "rows": 3072, "batchsize": 256, "f_training": 0.9,
        "f_validation": 0.1}}},
}


def _run(manifest, cell, overrides, seconds=0.3):
    if "mix" in overrides.get("traffic", {}):
        # a mix without sweeps reports no draws: the CPU path draws its
        # base sample with torch.randn, not the card's Philox stream
        manifest = copy.copy(manifest)
        manifest.data = copy.deepcopy(manifest.data)
        for m in manifest.data["end_to_end"]:
            if m["name"] == "sample_draws_per_s":
                m["workloads"] = [w for w in m["workloads"] if w != cell]
        limits = manifest.limits
        manifest.limits = lambda c: {k: v for k, v in limits(c).items()
                                     if k != "sample_gap"}
    return execute(manifest, cell, 2**31 + 77, seconds, False, "cpu",
                   time.time(), overrides=overrides)


@pytest.mark.parametrize("cell", sorted(SERVE))
def test_sound_serving_run_is_correct(manifest, cell):
    assert _run(manifest, cell, SERVE[cell])["correct"]


@pytest.mark.parametrize("cell", sorted(SERVE))
def test_altered_answer(manifest, cell, monkeypatch):
    real = Flow.log_prob

    def altered(self, x, theta=None, **kw):
        out = real(self, x, theta, **kw).clone()
        out[-1] += 1e-3 * (1.0 + out[-1].abs())
        return out

    monkeypatch.setattr(Flow, "log_prob", altered)
    line = _run(manifest, cell, SERVE[cell])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_sound_training_run_is_correct(manifest, cell):
    assert _run(manifest, cell, TRAIN[cell], 0.1)["correct"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_state_returned_unchanged(manifest, cell, monkeypatch):
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

    monkeypatch.setattr(dt, "train", unchanged)
    line = _run(manifest, cell, TRAIN[cell], 0.1)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_half_the_batch(manifest, cell, monkeypatch):
    real = dt.train

    def half(flow, data, optimizer=None, opt_state=None, **kw):
        tr = np.asarray(data.partition.training)
        part = dt.DataPartition(tr[: max(1, len(tr) // 2)],
                                data.partition.validation,
                                data.partition.testing)
        return real(flow, dt.DataArrays(data.x, data.theta, part), optimizer,
                    opt_state, **kw)

    monkeypatch.setattr(dt, "train", half)
    line = _run(manifest, cell, TRAIN[cell], 0.1)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_partial_batch_left_out(manifest, cell, monkeypatch):
    real = dt.train

    def full_batches_only(flow, data, optimizer=None, opt_state=None, **kw):
        tr = np.asarray(data.partition.training)
        bs = kw["batchsize"]
        part = dt.DataPartition(tr[: max(bs, len(tr) // bs * bs)],
                                data.partition.validation,
                                data.partition.testing)
        return real(flow, dt.DataArrays(data.x, data.theta, part), optimizer,
                    opt_state, **kw)

    monkeypatch.setattr(dt, "train", full_batches_only)
    line = _run(manifest, cell, TRAIN[cell], 0.1)
    assert not line["correct"], line["checks"]
