"""The stage readers (``metrics/_stages.py`` and the eleven readers of the
port's stage spans) on a synthetic slice: device intervals and harness spans
built by hand, program spans placed in the port's recorder, every number
against its hand count; and nothing read where nothing was recorded."""

import collections
import sys

import pytest

from perfbench.manifest import load_reader
from perfbench.trace import Span, TraceSlice

spans = pytest.importorskip("densityflows_tpu_torch.utils.spans")
P = spans.Span

SERVE = ["theta_ms.logprob", "plan_ms.logprob", "enqueue_ms.logprob",
         "plan_hit.serve", "unnamed_ms.logprob"]
TRAIN = ["gather_ms.train", "fold_ms.train", "upload_ms.train",
         "upload_mb.train", "eval_ms.train", "unnamed_ms.train"]


def _serve_slice():
    harness = [Span("log_prob", 1000, 3000, {}),
               Span("sample", 4000, 5000, {}),
               Span("log_prob", 6000, 8000, {})]
    device = [("k", 2500, 2900), ("k", 4500, 4900), ("k", 7000, 7900)]
    program = [
        # a log_prob call
        P(0, "df.log_prob", 1100, 2950, None, 0, {}),
        P(1, "df.theta", 1200, 1400, 0, 0, {}),
        P(2, "df.plan", 1400, 1800, 0, 0, {"hit": 0}),
        P(3, "df.enqueue", 1800, 2500, 0, 0, {}),
        P(4, "df.density", 2500, 2900, 0, 0, {}),
        # a sweep
        P(5, "df.sample_sweep", 4100, 4950, None, 1, {}),
        P(6, "df.plan", 4200, 4300, 5, 1, {"hit": 1}),
        P(7, "df.enqueue", 4300, 4500, 5, 1, {}),
        # a log_prob call
        P(8, "df.log_prob", 6100, 7950, None, 2, {}),
        P(9, "df.theta", 6200, 6300, 8, 2, {}),
        P(10, "df.plan", 6300, 6400, 8, 2, {"hit": 1}),
        P(11, "df.enqueue", 6400, 7000, 8, 2, {}),
        P(12, "df.density", 7000, 7900, 8, 2, {}),
        # a root outside every harness call (set-up): left out
        P(13, "df.log_prob", 8500, 8600, None, 3, {}),
        P(14, "df.theta", 8510, 8590, 13, 3, {}),
    ]
    return TraceSlice(0, 10_000, harness, device), program


def _train_slice():
    harness = [Span("train", 1000, 50_000, {}),
               Span("train", 60_000, 90_000, {})]
    # the training kernel, the evaluation's work after it, then the
    # resident route's kernel
    device = [("k", 5000, 15_000), ("e", 15_500, 39_000),
              ("k", 63_000, 87_000)]
    program = [
        # the streaming route
        P(0, "df.train", 1100, 49_000, None, 0, {}),
        P(1, "df.gather", 1200, 2200, 0, 0, {}),
        P(2, "df.fold", 2200, 3200, 0, 0, {}),
        P(3, "df.upload", 3200, 4200, 0, 0, {"bytes": 1_000_000}),
        P(4, "df.enqueue", 4200, 10_000, 0, 0, {}),
        P(5, "df.upload", 5000, 6000, 4, 0, {"bytes": 500_000}),
        P(6, "df.eval", 10_000, 20_000, 0, 0, {}),
        P(7, "df.wait", 20_000, 40_000, 0, 0, {}),
        P(8, "df.unfold", 40_000, 45_000, 0, 0, {}),
        # the resident route
        P(9, "df.train", 60_100, 89_000, None, 1, {}),
        P(10, "df.fold", 60_200, 61_000, 9, 1, {}),
        P(11, "df.upload", 61_000, 62_000, 9, 1, {"bytes": 2_000_000}),
        P(12, "df.enqueue", 62_000, 63_000, 9, 1, {}),
        P(13, "df.wait", 63_000, 88_000, 9, 1, {}),
        P(14, "df.unfold", 88_000, 88_500, 9, 1, {}),
    ]
    return TraceSlice(0, 100_000, harness, device), program


@pytest.fixture
def recorder(monkeypatch):
    def place(program):
        monkeypatch.setattr(spans, "_BUFFER", collections.deque(program))
    return place


def test_serving_stages(recorder):
    sl, program = _serve_slice()
    recorder(program)
    read = {name: load_reader(name).read(sl) for name in SERVE}
    # (200 + 100) ns, (400 + 100), (700 + 600) over the two log_prob calls
    assert read["theta_ms.logprob"] == pytest.approx(150e-6)
    assert read["plan_ms.logprob"] == pytest.approx(250e-6)
    assert read["enqueue_ms.logprob"] == pytest.approx(650e-6)
    # hits 0, 1 (the sweep), 1
    assert read["plan_hit.serve"] == pytest.approx(200.0 / 3)
    # idle 1600 of which the stages cover 1300; idle 1100, covered 800
    assert read["unnamed_ms.logprob"] == pytest.approx(300e-6)


def test_training_stages(recorder):
    sl, program = _train_slice()
    recorder(program)
    read = {name: load_reader(name).read(sl) for name in TRAIN}
    assert read["gather_ms.train"] == pytest.approx(500e-6)
    # fold + unfold: 1000 + 5000, 800 + 500
    assert read["fold_ms.train"] == pytest.approx(3650e-6)
    # the batch order's copy inside the enqueue counts as an upload
    assert read["upload_ms.train"] == pytest.approx(1500e-6)
    assert read["upload_mb.train"] == pytest.approx(1.75)
    # 10000 less the 5000 in which the kernel begun before it still runs
    assert read["eval_ms.train"] == pytest.approx(2500e-6)
    # idle 15000, covered 9800; idle 6000, covered 4300
    assert read["unnamed_ms.train"] == pytest.approx(3450e-6)


def test_self_time_and_the_assignment_of_roots(recorder):
    from perfbench.metrics import _stages

    own = _stages.self_ns(_train_slice()[1])
    assert own[4] == 4800 and own[0] == 47_900 - 43_800
    sl, program = _serve_slice()
    recorder(program)
    found = {kind: [(h.start, sorted(s.index for s in group))
                    for h, group in _stages.calls(sl, kind)]
             for kind in ("log_prob", "sample")}
    assert found == {"log_prob": [(1000, list(range(5))),
                                  (6000, list(range(8, 13)))],
                     "sample": [(4000, [5, 6, 7])]}


def test_a_resident_cell_reads_no_evaluation(recorder):
    sl, program = _train_slice()
    recorder([s for s in program if s.call == 1])
    assert load_reader("eval_ms.train").read(sl) is None
    assert load_reader("upload_mb.train").read(sl) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_recorded_reads_none(recorder, monkeypatch, name):
    sl = (_serve_slice() if name in SERVE else _train_slice())[0]
    recorder([])
    assert load_reader(name).read(sl) is None
    # a program without the recorder (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "densityflows_tpu_torch.utils.spans",
                        None)
    assert load_reader(name).read(sl) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_units_are_the_manifests(manifest, name):
    entry = [m for m in manifest.data["per_layer"] if m["name"] == name][0]
    assert load_reader(name).UNIT == entry["unit"]
    assert entry["source"] == "device_trace" and entry["workloads"]
