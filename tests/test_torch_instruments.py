"""The port's instruments on the CPU: ``utils/profiling.py`` (``StepTimer``,
``Throughput``, ``trace`` / ``annotate``, ``device_count``) and
``parallel/scaling.py`` (``scaling_report`` on two gloo ranks in two
processes, ``_torch_mesh2d_worker.py`` mode ``scaling``, mirroring JAX
``tests/test_sharding.py::test_scaling_report_runs``)."""

import json
import os

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.parallel import scaling as S
from densityflows_tpu_torch.utils import profiling as P

import _torch_cpu  # noqa: F401
from _torch_mesh2d_worker import run_ranks


def test_step_timer_statistics_are_numpys():
    timer = P.StepTimer()
    assert (timer.mean_ms, timer.p50_ms, timer.p99_ms) == (0.0, 0.0, 0.0)
    known = [0.004, 0.001, 0.003, 0.010, 0.002]
    timer.times.extend(known)
    assert timer.mean_ms == 1e3 * float(np.mean(known))
    assert timer.p50_ms == 1e3 * float(np.percentile(known, 50))
    assert timer.p99_ms == 1e3 * float(np.percentile(known, 99))
    # stop() appends the elapsed seconds; block_on may nest containers
    t = torch.ones(3)
    with timer.step({"a": [t, (t,)], "b": None}):
        t.add_(1.0)
    assert len(timer.times) == 6 and timer.times[-1] >= 0.0
    timer.start()
    assert timer.stop() == timer.times[-1]


def test_throughput_per_chip_divides_by_the_device_count():
    tp = P.Throughput()
    assert tp.per_sec == 0.0
    tp.add(3000, 1.5)
    tp.add(1000, 0.5)
    assert tp.per_sec == 2000.0
    assert P.device_count() == (torch.cuda.device_count()
                                if torch.cuda.is_available() else 1)
    assert tp.per_sec_per_chip == tp.per_sec / P.device_count()


def test_trace_writes_the_annotated_region(tmp_path):
    logdir = str(tmp_path / "trace")
    with P.trace(logdir):
        with P.annotate("df_annotated_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        text = f.read()
    assert "df_annotated_region" in text
    json.loads(text)


def test_scaling_report_validates_device_counts():
    make = lambda g: dt.flow_chain(dt.coupling_block(  # noqa: E731
        4, None, n=1, generator=g, hidden_dim_s=8, hidden_dim_t=8,
        device="cpu"))
    with pytest.raises(ValueError, match="world size"):
        S.scaling_report(make, 4, 1, device_counts=[2], device="cpu")


def test_scaling_report_on_two_ranks():
    """device_counts [1, 2], 64 rows a device, 2 timed reps: both ranks get
    the same list, the rates are positive, the first point's train
    efficiency is 1.0, the times are the wall clock's and the train step is
    the plain data-parallel step (a CPU flow)."""
    import tempfile

    with tempfile.TemporaryDirectory() as folder:
        ranks = run_ranks("scaling", folder)
    lists = [json.loads(str(r["points"])) for r in ranks]
    assert lists[0] == lists[1]
    names = [f.name for f in S.ScalingPoint.__dataclass_fields__.values()]
    pts = [S.ScalingPoint(**dict(zip(names, p))) for p in lists[0]]
    assert [p.n_devices for p in pts] == [1, 2]
    for p in pts:
        assert p.train_samples_per_sec > 0 and p.sample_draws_per_sec > 0
        assert (p.train_method, p.sample_method) == ("wall", "wall")
        assert p.train_path == "torch"
        assert p.train_spread >= 0 and p.sample_spread >= 0
    assert pts[0].train_efficiency == 1.0
    assert pts[0].sample_efficiency == 1.0
