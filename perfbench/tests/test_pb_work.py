"""The operation counts against hand counts."""

import json
import os

from perfbench import work
from perfbench.run import ROOT


def _cfg(name):
    return json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                       name + ".json")))


def test_emulator32_forward():
    w = work.of(_cfg("emulator32"))
    # 8 couplings x 2 nets x (24*256 + 256*256 + 256*16)
    assert w.macs == 8 * 2 * (24 * 256 + 256 * 256 + 256 * 16) == 1_212_416
    ops, _ = w.logprob(1)
    assert abs(ops - 2.425e6) < 1e3
    ops, _ = w.logprob(2**18)
    assert abs(ops / 1e9 - 635.7) < 0.1
    # weights and biases of 16 nets
    assert w.params == 16 * (24 * 256 + 256 + 256 * 256 + 256 + 256 * 16 + 16)


def test_quickstart5_forward():
    w = work.of(_cfg("quickstart5"))
    # each coupling: 1 theta + 2 identity dims in, 3 out, hidden 16
    assert w.macs == 3 * 2 * (3 * 16 + 16 * 16 + 16 * 3) == 2112
    ops, _ = w.train(45_000, 50 * 15)
    assert ops == 3 * 2 * 2112 * 45_000


def test_bytes_and_bound():
    w = work.of(_cfg("emulator32"))
    _, nbytes = w.logprob(10)
    assert nbytes == 4 * (10 * (32 + 8 + 1) + w.params)
    _, nbytes = w.sample(160, 16)
    assert nbytes == 4 * (16 * 8 + 160 * 32 + w.params)
    assert work.least_seconds(495e12, 0) == 1.0
    assert work.least_seconds(0, 3.35e12) == 1.0
