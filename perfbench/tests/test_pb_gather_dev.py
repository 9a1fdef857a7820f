"""gather_dev.train's reader on a synthetic slice: the count dev of the
df.gather spans that pick the splits' rows, over the train() calls; the
batch order's df.gather (no count) and a root outside every call left out;
nothing read where nothing was recorded or no span carries the count."""

import collections
import sys

import pytest

from perfbench.manifest import load_reader
from perfbench.trace import Span, TraceSlice

spans = pytest.importorskip("densityflows_tpu_torch.utils.spans")
P = spans.Span
NAME = "gather_dev.train"


def _slice():
    harness = [Span("train", 1000, 20_000, {}),
               Span("train", 30_000, 50_000, {}),
               Span("train", 60_000, 80_000, {})]
    device = [("k", 5000, 15_000), ("k", 35_000, 45_000),
              ("k", 65_000, 75_000)]
    program = [
        # the kernel path: the splits picked on the device, then the batch
        # order
        P(0, "df.train", 1100, 19_000, None, 0, {}),
        P(1, "df.upload", 1200, 2000, 0, 0, {"bytes": 1000}),
        P(2, "df.gather", 2000, 2500, 0, 0, {"dev": 1}),
        P(3, "df.gather", 3000, 3500, 0, 0, {}),
        # the host gather (a large testing split)
        P(4, "df.train", 30_100, 49_000, None, 1, {}),
        P(5, "df.gather", 30_200, 31_000, 4, 1, {"dev": 0}),
        P(6, "df.upload", 31_000, 32_000, 4, 1, {"bytes": 500}),
        # the plain program, on the device
        P(7, "df.train", 60_100, 79_000, None, 2, {}),
        P(8, "df.upload", 60_200, 61_000, 7, 2, {"bytes": 1000}),
        P(9, "df.gather", 61_000, 61_500, 7, 2, {"dev": 1}),
        # a root outside every harness call (set-up): left out
        P(10, "df.train", 85_000, 86_000, None, 3, {}),
        P(11, "df.gather", 85_100, 85_200, 10, 3, {"dev": 0}),
    ]
    return TraceSlice(0, 100_000, harness, device), program


@pytest.fixture
def recorder(monkeypatch):
    def place(program):
        monkeypatch.setattr(spans, "_BUFFER", collections.deque(program))
    return place


def test_the_share_of_calls_that_gathered_on_the_device(recorder):
    sl, program = _slice()
    recorder(program)
    assert load_reader(NAME).read(sl) == pytest.approx(200.0 / 3)
    recorder([s for s in program if s.call == 0])
    assert load_reader(NAME).read(sl) == pytest.approx(100.0)


def test_nothing_to_read_reads_none(recorder, monkeypatch):
    sl, program = _slice()
    # a program whose spans carry no dev (one without the count)
    recorder([s._replace(counts={}) if s.name == "df.gather" else s
              for s in program])
    assert load_reader(NAME).read(sl) is None
    recorder([])
    assert load_reader(NAME).read(sl) is None
    monkeypatch.setitem(sys.modules, "densityflows_tpu_torch.utils.spans",
                        None)
    assert load_reader(NAME).read(sl) is None


def test_the_manifest_entry(manifest):
    entry = [m for m in manifest.data["per_layer"] if m["name"] == NAME][0]
    assert load_reader(NAME).UNIT == entry["unit"] == "%"
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "train_rows_per_s"
    assert entry["workloads"] == ["emulator32.train", "quickstart5.train",
                                  "dingo_nsf15.train"]
