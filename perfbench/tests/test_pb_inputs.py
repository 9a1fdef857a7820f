"""Traffic and inputs are a function of the seed."""

import itertools
import json
import os

import numpy as np
import torch

from perfbench.generators.serve import Requests
from perfbench.inputs import Problem, draw_weights
from perfbench.run import ROOT


def _traffic(name):
    return json.load(open(os.path.join(ROOT, "perfbench", "traffic",
                                       name + ".json")))


def _cfg(name):
    return json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                       name + ".json")))


def test_request_stream_is_deterministic():
    t = _traffic("serve_wide")
    a = list(itertools.islice(Requests(t, 2**31 + 5, 2**20, 4096), 300))
    b = list(itertools.islice(Requests(t, 2**31 + 5, 2**20, 4096), 300))
    c = list(itertools.islice(Requests(t, 2**31 + 6, 2**20, 4096), 300))
    assert a == b and a != c


def test_every_seed_serves_the_same_sizes():
    t = _traffic("serve_wide")
    blocks = []
    for seed in (1, 2**33 + 1):
        reqs = list(itertools.islice(Requests(t, seed, 2**20, 4096), 64))
        blocks.append(sorted((r["op"], r["rows"]) for r in reqs))
        assert sum(r["op"] == "log_prob" for r in reqs) == 48
        assert all(r["rows"] % 16 == 0 for r in reqs if r["op"] == "sample")
        assert max(r["rows"] for r in reqs) <= 2**18
        assert min(r["rows"] for r in reqs) >= 2**12
    assert blocks[0] == blocks[1]


def test_one_operation_mix():
    t = {"mix": {"log_prob": 1}, "block": 64, "rows_log2": [0, 12],
         "grid": 1, "check_every": 16}
    reqs = list(itertools.islice(Requests(t, 3, 65536, 4096), 128))
    assert all(r["op"] == "log_prob" for r in reqs)
    assert min(r["rows"] for r in reqs) == 1 and max(r["rows"] for r in reqs) <= 4096


def test_weights_and_data_are_seeded():
    cfg = _cfg("emulator32")
    f1, _ = draw_weights(cfg, 12, "cpu")
    f2, views = draw_weights(cfg, 12, "cpu")
    f3, _ = draw_weights(cfg, 13, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert views["c0.s.w0"].shape == (24, 256)
    assert views["c7.t.w2"].shape == (256, 16)
    p1, p2 = Problem(cfg, 12, "cpu"), Problem(cfg, 12, "cpu")
    x1, t1 = p1.rows(100, "a")
    x2, t2 = p2.rows(100, "a")
    assert torch.equal(x1, x2) and torch.equal(t1, t2)
    assert float(t1.min()) >= -1.0 and float(t1.max()) <= 2.0
    tr, va = p1.split(1000)
    assert len(tr) == 900 and len(va) == 100
    assert len(np.intersect1d(tr, va)) == 0


def test_file_data_is_the_frozen_copy():
    cfg = _cfg("quickstart5")
    p = Problem(cfg, 4, "cpu")
    orig = np.load(os.path.join(ROOT, "perfbench", "data", "datatest.npz"))
    assert p.file_x.shape == (1000, 5)
    assert np.array_equal(p.file_x.numpy(), orig["x"])
    assert float(p.theta_lo) == -1.0 and float(p.theta_hi) == 2.0
