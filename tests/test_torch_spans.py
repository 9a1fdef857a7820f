"""The port's stage spans (``densityflows_tpu_torch/utils/spans.py``) on the
CPU: nothing recorded and no ``record_function`` made without a profiler;
under ``torch.profiler`` the roots and stages of ``Flow.log_prob``,
``Flow.sample_sweep`` and ``train()`` (the kernel path's plain versions:
``set_fused_kernels(True)``, ``fused_kernel=True``), their parents, calls
and counts; and every span inside the profiler's own event for it (the
shared clock)."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import densityflows_tpu_torch as dt
from densityflows_tpu_torch import data as D
from densityflows_tpu_torch.models import fused_train as FT
from densityflows_tpu_torch.utils import profiling as P
from densityflows_tpu_torch.utils import spans as S

import _torch_cpu  # noqa: F401

SERVE_STAGES = {
    "df.log_prob": ["df.theta", "df.plan", "df.enqueue", "df.density"],
    "df.sample_sweep": ["df.theta", "df.plan", "df.enqueue"],
}
TRAIN_STAGES = {
    "resident": ["df.fold", "df.upload", "df.gather", "df.fold", "df.gather",
                 "df.enqueue", "df.wait", "df.unfold"],
    "stream": ["df.fold", "df.upload", "df.gather", "df.fold", "df.gather",
               "df.enqueue", "df.eval", "df.wait", "df.unfold"],
    "plain": ["df.upload", "df.gather"],
}


def _plain_stages(data, flow, epochs, batchsize):
    """The plain program's stages: the upload and gather, then per step the
    loss, its gradient and the update, and per epoch the evaluation."""
    n = data.normalized_training_data(flow.metadata)[0].shape[0]
    steps = -(-n // batchsize)
    return TRAIN_STAGES["plain"] + epochs * (
        steps * ["df.forward", "df.backward", "df.adam"] + ["df.eval"])


@pytest.fixture
def case():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    th = rng.uniform(-1.0, 2.0, (200, 1)).astype(np.float32)
    data = dt.DataArrays.make(x, th, rng=0)
    chain = dt.flow_chain(dt.coupling_block(
        4, None, n=1, generator=torch.Generator().manual_seed(0),
        hidden_dim_s=8, hidden_dim_t=8, device="cpu"))
    dt.set_fused_kernels(True)
    try:
        yield dt.Flow(chain, data, device="cpu"), data, x, th
    finally:
        dt.set_fused_kernels("auto")


def _calls(spans):
    """call → its spans in the order they opened."""
    out = collections.defaultdict(list)
    for s in sorted(spans, key=lambda s: (s.start_ns, s.index)):
        out[s.call].append(s)
    return list(out.values())


def _check_call(group, root_name, stages):
    root = group[0]
    assert root.name == root_name and root.parent is None
    assert [s.name for s in group[1:]] == stages
    for s in group[1:]:
        assert s.call == root.call
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    return root


def _upload_bytes(data, flow):
    """The raw rows, θ, its bounds and both splits' int64 indices: the
    splits hold every row, so they are gathered on the device."""
    meta, part = flow.metadata, data.partition
    return (data.x.nbytes + data.theta.nbytes + meta.theta_min.nbytes
            + meta.theta_max.nbytes
            + 8 * (part.training.size + part.validation.size))


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch, case):
    flow, data, x, th = case

    class NoClock:
        @staticmethod
        def time_ns():
            raise AssertionError("a span read the clock with nothing "
                                 "recording")

    def no_record_function(name):
        raise AssertionError("a span made a record_function with nothing "
                             "recording")

    def no_count(*arrays):
        raise AssertionError("a span site computed a count with nothing "
                             "recording")

    monkeypatch.setattr(S, "time", NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    monkeypatch.setattr(D, "_nbytes", no_count)
    assert not torch.autograd._profiler_enabled()
    before = len(S.recorded())
    assert S.span("df.log_prob", rows=3) is S.span("df.plan")
    with S.span("df.log_prob", rows=3) as root:
        assert not root.recording
        assert not hasattr(root, "counts")
    flow.log_prob(x[:16], th[:16])
    flow.sample_sweep(th[:2], 4, generator=torch.Generator().manual_seed(1))
    dt.train(flow, data, epochs=1, batchsize=32, verbose=False,
             fused_kernel=True)
    dt.train(flow, data, epochs=1, batchsize=32, verbose=False,
             fused_kernel=False)
    assert len(S.recorded()) == before


def test_an_unrecorded_span_does_not_record_under_a_profiler():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert S.span("df.plan").recording
        with S.unrecorded("df.plan") as s:
            assert not s.recording
    with profile(activities=[ProfilerActivity.CPU]):
        with S.span("df.plan"):
            pass
    assert [s.name for s in S.recorded(t0, time.time_ns())] == ["df.plan"]


def test_annotate_is_the_stage_span():
    assert P.annotate is S.span


def test_serving_records_its_stages_and_the_plan_cache(case):
    flow, data, x, th = case
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        flow.log_prob(x[:50], th[:50])
        flow.log_prob(x[:50], th[:50])
        for seed in (1, 2):
            flow.sample_sweep(th[:3], 5,
                              generator=torch.Generator().manual_seed(seed))
    groups = _calls(S.recorded(t0, time.time_ns()))
    names = ["df.log_prob", "df.log_prob", "df.sample_sweep",
             "df.sample_sweep"]
    assert [g[0].name for g in groups] == names
    assert len({g[0].call for g in groups}) == 4
    for group, name, hit in zip(groups, names, [0, 1, 0, 1]):
        root = _check_call(group, name, SERVE_STAGES[name])
        assert root.counts == {}
        assert all(s.parent == root.index for s in group[1:])
        assert [s.counts for s in group if s.name == "df.plan"] == [
            {"hit": hit}]


@pytest.mark.parametrize("route", ["resident", "stream", "plain"])
def test_train_records_its_stages_and_the_bytes_uploaded(monkeypatch, case,
                                                         route):
    flow, data, x, th = case
    if route == "stream":
        monkeypatch.setattr(FT, "MAX_SHARED_BYTES", 1000)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        dt.train(flow, data, epochs=2, batchsize=32, verbose=False,
                 fused_kernel=route != "plain")
    (group,) = _calls(S.recorded(t0, time.time_ns()))
    root = _check_call(group, "df.train", (
        _plain_stages(data, flow, 2, 32) if route == "plain"
        else TRAIN_STAGES[route]))
    assert flow.fused_kernel_mode == (None if route == "plain" else route)
    assert root.counts == {}
    assert all(s.parent == root.index for s in group[1:])
    uploads = [s.counts["bytes"] for s in group if s.name == "df.upload"]
    # a CPU flow copies the raw rows and the splits' indices once; the batch
    # order is copied by the CUDA wrappers alone
    assert uploads == [_upload_bytes(data, flow)] == [5608]
    # the splits' rows are picked on the device; the batch order's gather
    # carries no count
    assert [s.counts for s in group if s.name == "df.gather"] == (
        [{"dev": 1}] + ([] if route == "plain" else [{}]))
    # the stream mode's launches say which design they take: on the CPU the
    # plain version runs, neither design
    enqueues = [s.counts for s in group if s.name == "df.enqueue"]
    assert enqueues == ([{"tc": 0}] if route == "stream"
                        else [{}] * len(enqueues))
    # each plain step counts its batch's rows (the last batch padded)
    steps = _plain_stages(data, flow, 2, 32).count("df.forward")
    assert [s.counts for s in group if s.name == "df.forward"] == (
        [{"rows": 32}] * steps if route == "plain" else [])
    assert all(s.counts == {} for s in group
               if s.name not in ("df.upload", "df.gather", "df.enqueue",
                                 "df.forward"))


def test_a_train_call_inside_another_is_its_stage(case):
    """The debug route runs its chunks as inner ``train()`` calls: their
    ``df.train`` spans are stages of the outer call."""
    flow, data, x, th = case
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        dt.train(flow, data, epochs=12, batchsize=64, verbose=False,
                 fused_kernel=False, debug=True)
    (group,) = _calls(S.recorded(t0, time.time_ns()))
    root = group[0]
    inner = [s for s in group if s.name == "df.train" and s is not root]
    assert [s.parent for s in inner] == [root.index] * 2
    for outer, epochs in zip(inner, (10, 2)):
        stages = [s.name for s in group if s.parent == outer.index]
        assert stages == _plain_stages(data, flow, epochs, 64)


def test_spans_lie_within_the_profilers_events_for_them(case):
    """The spans are stamped in Unix-epoch ns, as the profiler stamps its
    events. A call's spans lie within 5 ms of the profiler's events for
    them: the profiler converts its cycle counter to the wall clock at the
    ends of its session, and the wall clock of some virtual machines steps
    by ~0.5 ms every ~0.1 s. With the call shifted by the median of those
    offsets, every span of the call lies within the profiler's event for it
    to 200 µs at each end. The session is long (a second's sleep), so that
    the profiler's conversion is fitted over more than a step of the wall
    clock."""
    flow, data, x, th = case
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(1.0)
        flow.log_prob(x[:50], th[:50])
        flow.sample_sweep(th[:3], 5,
                          generator=torch.Generator().manual_seed(1))
        dt.train(flow, data, epochs=1, batchsize=90, verbose=False,
                 fused_kernel=True)
    spans = S.recorded(t0, time.time_ns())
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("df."):
            events[ev.name()].append((ev.start_ns(),
                                      ev.start_ns() + ev.duration_ns()))
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    assert set(by_name) == set(events) and len(spans) == 18
    event_of = {}
    for name, mine in by_name.items():
        assert len(mine) == len(events[name]), name
        for s, ev in zip(sorted(mine, key=lambda s: s.start_ns),
                         sorted(events[name])):
            event_of[s.index] = ev
    slack = 200_000
    for group in _calls(spans):
        shift = float(np.median([event_of[s.index][0] - s.start_ns
                                 for s in group]))
        assert abs(shift) <= 5_000_000
        for s in group:
            e0, e1 = event_of[s.index]
            assert e0 - slack <= s.start_ns + shift, s.name
            assert s.end_ns + shift <= e1 + slack, s.name
