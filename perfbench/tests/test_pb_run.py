"""A whole run on the CPU at small sizes: the result line's keys, the exit
without a card, the JAX check, and a cell added as files only."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench.manifest import Manifest, load_reader
from perfbench.run import ROOT, execute, forbidden_modules
from perfbench.trace import Span, TraceSlice

SMALL = {"config": {"train": {"rows": 1000, "batchsize": 64, "epochs": 1,
                             "f_training": 0.9, "f_validation": 0.1}}}


def test_result_line_keys(manifest):
    line = execute(manifest, "quickstart5.train", 2**31 + 3, 0.1, False,
                   "cpu", time.time(), overrides=SMALL)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_rows_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"loss_gap", "epoch_loss_gap",
                                   "fit_loss_gap", "grad_gap", "step_gap"}
    json.dumps(line)


def test_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "emulator32.serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_exits_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "emulator32.serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "densityflows_tpu", "densityflows_tpu.models.flow",
             "densityflows_tpu_torch", "densityflows_tpu_torch.train",
             "jaxtyping", "numpy"]
    assert forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "densityflows_tpu", "densityflows_tpu.models.flow"])
    assert forbidden_modules(["densityflows_tpu_torch.models"]) == []


NICE_KIND = '''"""Kind nice_flow: additive (NICE) couplings, a normalization layer."""
import math

import torch

from ..reference.nice_flow import param_layout

KERNELS = {}


def build(cfg, leaves_, problem, device):
    import densityflows_tpu_torch as dt
    from densityflows_tpu_torch.models.layers import NICECouplingLayer

    from ..system import load_leaves

    els = [dt.coupling_layer(cfg["d"], c["transform"], kind=NICECouplingLayer,
                             n=cfg["n_cond"], hidden_dim_t=cfg["hidden"],
                             n_sublayers_t=cfg["n_sublayers"],
                             generator=torch.Generator(), device=device)
           for c in cfg["couplings"]]
    norm = cfg["normalization"]
    els.append(dt.normalization_layer(problem.norm_x.cpu().numpy(),
                                      norm["alpha"], norm["beta"],
                                      device=device))
    meta = dt.MetaData("", cfg["d"], cfg["n_cond"],
                       problem.theta_lo.cpu().numpy(),
                       problem.theta_hi.cpu().numpy())
    flow = dt.Flow(dt.flow_chain(*els), meta, device=device)
    load_leaves(cfg, flow, leaves_)
    return flow


def leaves(cfg, flow):
    out = {}
    for ci, layer in enumerate(list(flow.model.layers)[:-1]):
        for li, (w, b) in enumerate(zip(layer.t_net.weights,
                                        layer.t_net.biases)):
            out[f"c{ci}.t.w{li}"], out[f"c{ci}.t.b{li}"] = w, b
    return out


class Work:
    def __init__(self, cfg):
        lay = param_layout(cfg)
        self.macs = sum(s[0] * s[1] for _, s, r in lay if r != "bias")
        self.params = sum(math.prod(s) for _, s, _ in lay)
        self.row = cfg["d"] + cfg["n_cond"] + 1

    def logprob(self, rows):
        return 2.0 * self.macs * rows, 4 * (rows * self.row + self.params)
'''

NICE_REFERENCE = '''"""Plain reference of kind nice_flow: z_af = x_af - t, no log-det."""
import torch

from . import realnvp_flow


def param_layout(cfg):
    return [e for e in realnvp_flow.param_layout(cfg) if ".t." in e[0]]


class Reference(realnvp_flow.Reference):
    def _st(self, ci, x, th_n):
        ident, af = self.axes[ci]
        t = self._net(ci, "t", torch.cat([th_n, x[:, ident]], dim=-1))
        return torch.zeros_like(t), t
'''


def test_a_kind_config_cell_metric_and_traffic_added_as_files_only(tmp_path):
    """A throw-away configuration kind (NICE couplings: its program side,
    its reference and its work), configuration, traffic mix, cell and
    per-layer metric, dropped into a copy of perfbench/ as new files, run
    from that copy with no file of the harness edited."""
    bench = tmp_path / "perfbench"
    shutil.copytree(os.path.join(ROOT, "perfbench"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    data["configs"].append({"name": "nice5", "source": "a test",
                            "file": "perfbench/configs/nice5.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "nice5.tiny", "config": "nice5",
                              "traffic": "tiny_mix", "chips": 1,
                              "why": "a test"})
    data["per_layer"].append({"name": "calls.logprob", "unit": "calls",
                              "better": "higher", "source": "device_trace",
                              "layer": "entry points", "moves":
                              "logprob_rows_per_s",
                              "workloads": ["nice5.tiny"]})
    for m in data["end_to_end"]:
        if m["name"] in ("logprob_rows_per_s", "request_p95_ms"):
            m["workloads"].append("nice5.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cfg = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                      "quickstart5.json")))
    cfg.update(name="nice5", kind="nice_flow")
    (bench / "configs" / "nice5.json").write_text(json.dumps(cfg))
    (bench / "kinds" / "nice_flow.py").write_text(NICE_KIND)
    (bench / "reference" / "nice_flow.py").write_text(NICE_REFERENCE)
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps({
        "generator": "serve", "mix": {"log_prob": 1}, "block": 8,
        "rows_log2": [2, 5], "grid": 1, "pool_rows": 256, "check_every": 2,
        "trace_seconds": 0.2}))
    (bench / "limits" / "nice5.tiny.json").write_text(
        json.dumps({"logprob_gap": 1e-5}))
    (bench / "metrics" / "calls.logprob.py").write_text(
        'UNIT = "calls"\n\n\ndef read(sl):\n'
        '    return float(len(sl.of("log_prob"))) or None\n')
    assert all(p.read_bytes() == b for p, b in before.items())
    probe = (
        "import json, sys, time\n"
        f"sys.path.append({ROOT!r})\n"
        "from perfbench.manifest import Manifest\n"
        "from perfbench.run import ROOT, execute\n"
        "import perfbench.kinds\n"
        "assert ROOT == sys.argv[1], ROOT\n"
        "assert perfbench.kinds.__file__.startswith(sys.argv[1])\n"
        "from perfbench.manifest import load_reader\n"
        "from perfbench.trace import Span, TraceSlice\n"
        "m = Manifest(ROOT)\n"
        "line = execute(m, 'nice5.tiny', 2**31 + 9, 0.3, False, 'cpu',\n"
        "               time.time())\n"
        "sl = TraceSlice(0, 100, [Span('log_prob', 10, 20, {})],\n"
        "                [('k', 12, 18)])\n"
        "reader = load_reader(m.per_layer('nice5.tiny')[-1]['name'])\n"
        "print(json.dumps([line['correct'], sorted(line['metrics']),\n"
        "                  line['checks'], reader.read(sl)]))\n")
    proc = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    correct, metrics, checks, calls = json.loads(
        proc.stdout.strip().splitlines()[-1])
    assert correct is True, checks
    assert metrics == ["logprob_rows_per_s", "request_p95_ms", "setup_s"]
    assert calls == 1.0


def test_trace_slice_arithmetic():
    from perfbench.manifest import load_reader

    work = {"rows": 10, "ops": 495e12 * 1e-9, "bytes": 0.0}
    sl = TraceSlice(0, 1000, [Span("log_prob", 100, 300, work),
                              Span("log_prob", 500, 700, work)],
                    [("a", 150, 200), ("b", 180, 250), ("c", 550, 600)])
    assert sl.busy_ns() == 150
    assert sl.device_s(sl.spans[0]) == pytest.approx(100e-9)
    assert load_reader("idle.serve").read(sl) == pytest.approx(85.0)
    assert load_reader("host_ms.logprob").read(sl) == pytest.approx(125e-6)
    assert load_reader("logprob_roofline").read(sl) == pytest.approx(
        100.0 * 2e-9 / 150e-9)
    assert load_reader("mfu.logprob").read(sl) == pytest.approx(0.5)
    assert load_reader("mfu.sample").read(sl) is None
    bd = sl.breakdown()
    assert bd["device_ops"][0][0] == "b"
    idle = dict((n.split(":")[0], t) for n, t in bd["idle_gaps"])
    # 100-150 and 250-300 in the first call, 500-550 and 600-700 in the
    # second; 0-100, 300-500 and 700-1000 between calls
    assert idle == pytest.approx({"in log_prob": 250e-9,
                                  "between calls (harness)": 600e-9})
