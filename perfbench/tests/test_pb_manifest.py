"""BENCHMARK.json and every file it names load, and agree with each other."""

import json
import os

import pytest

from perfbench.manifest import load_reader
from perfbench.run import ROOT

E2E = {"logprob_rows_per_s", "sample_draws_per_s", "request_p95_ms",
       "train_rows_per_s", "setup_s"}
PER_LAYER = {"mfu.logprob", "mfu.sample", "mfu.train", "host_ms.logprob",
             "host_ms.train", "logprob_roofline", "sample_roofline",
             "train_roofline", "idle.serve", "idle.train"}
CELLS = ["emulator32.serve", "emulator32.train", "quickstart5.train"]


def test_top_level_keys(manifest):
    assert list(manifest.data) == ["command", "paths", "run_seconds",
                                   "configs", "workloads", "end_to_end",
                                   "per_layer"]
    assert manifest.data["command"] == ["python3", "perfbench/run.py"]
    assert manifest.data["paths"] == ["perfbench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_metrics_and_cells(manifest):
    assert {m["name"] for m in manifest.data["end_to_end"]} == E2E
    assert {m["name"] for m in manifest.data["per_layer"]} == PER_LAYER
    assert [w["name"] for w in manifest.data["workloads"]] == CELLS
    assert all(w["chips"] == 1 for w in manifest.data["workloads"])
    for m in manifest.data["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                       "device_trace")
    e2e = {m["name"]: m for m in manifest.data["end_to_end"]}
    for m in manifest.data["per_layer"]:
        # every cell of a per-layer metric reports the metric it moves
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(manifest, cell):
    w = manifest.cell(cell)
    cfg = manifest.config(w["config"])
    from perfbench import kinds, reference

    assert cfg["dtype"] == "float32"
    assert callable(kinds.module(cfg).build)
    assert callable(reference.module(cfg).Reference)
    entry = [c for c in manifest.data["configs"] if c["name"] == w["config"]][0]
    assert entry["reduced"] == cfg["reduced"] and entry["source"] == cfg["source"]
    traffic = manifest.traffic(w["traffic"])
    assert callable(manifest.generator(traffic).run)
    limits = manifest.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    kinds = {m["name"] for m in manifest.end_to_end(cell)}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert manifest.per_layer(cell)


@pytest.mark.parametrize("name", sorted(PER_LAYER))
def test_reader_per_metric(manifest, name):
    entry = [m for m in manifest.data["per_layer"] if m["name"] == name][0]
    reader = load_reader(name)
    assert reader.UNIT == entry["unit"]
    assert callable(reader.read)


def test_names_are_well_formed(manifest):
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    d = manifest.data
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in d[group]:
            assert name.match(e["name"]), e["name"]
    for w in d["workloads"]:
        assert name.match(w["traffic"]) and len(w["why"]) <= 200
    for c in d["configs"]:
        assert len(c["source"]) <= 200 and c["file"].startswith("perfbench/")
        json.load(open(os.path.join(ROOT, c["file"])))
