"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose
  ``generator`` names a module of ``perfbench/generators/``;
- the limits of a cell's comparison: ``perfbench/limits/<cell>.json``;
- a per-layer metric's reader: ``perfbench/metrics/<metric>.py``.

Adding a configuration, a traffic mix, a cell or a metric is adding entries
and files; no file of the harness changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

__all__ = ["Manifest", "load_reader"]

HERE = os.path.dirname(os.path.abspath(__file__))


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, root: str = HERE):
    """The reader module of the per-layer metric ``name``."""
    path = os.path.join(root, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod_name = "perfbench.metrics._reader_" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "perfbench.metrics"
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, repo_root: str, bench_root: str = HERE):
        self.repo_root, self.bench_root = repo_root, bench_root
        self.data = _read_json(os.path.join(repo_root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = _read_json(os.path.join(self.repo_root, c["file"]))
                if cfg.get("name") != name:
                    raise ValueError(f"{c['file']} names {cfg.get('name')!r}")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read_json(os.path.join(self.bench_root, "traffic",
                                       name + ".json"))

    def limits(self, cell: str) -> dict:
        return _read_json(os.path.join(self.bench_root, "limits",
                                       cell + ".json"))

    def generator(self, traffic: dict):
        return importlib.import_module("perfbench.generators."
                                       + traffic["generator"])

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if self._applies(m, cell)]
