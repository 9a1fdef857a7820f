"""One run of one benchmark cell of densityflows_tpu_torch.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the weights and inputs on the card from ``--seed``, builds the
program's kernels into the checkout's ``build/`` directory (the first run of
a checkout compiles them), warms the cell's shapes, measures for
``--seconds`` (``--trace 1``: profiles a bounded slice instead), compares
what the timed path produced with the plain reference, and prints one JSON
line last on standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics. Each compared number and
its limit are the last lines on standard error and the last key of the line.

It exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when the program is not in this checkout, and when
the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "densityflows_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Entries of ``sys.modules`` (or ``names``) whose top-level name is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


class Context:
    """What a generator gets: the cell's configuration and traffic, the run's
    arguments and the places it reports to."""

    def __init__(self, cfg, traffic, seed, seconds, trace, device, t_start,
                 err=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device, self.t_start = device, t_start
        self.err = err if err is not None else sys.stderr
        self.marks = {"imports": time.time() - t_start}

    def mark(self, name: str) -> None:
        """Record the seconds since the process started at a step of
        set-up (``imports`` is recorded when the generator is handed
        the run)."""
        self.marks[name] = time.time() - self.t_start

    def log(self, msg: str) -> None:
        print(msg, file=self.err, flush=True)

    def log_line(self, key: str, value) -> None:
        print(json.dumps({key: value}, default=str), file=self.err,
              flush=True)

    def memory_peak(self) -> int:
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
            return int(max(torch.cuda.max_memory_allocated(i)
                           for i in range(torch.cuda.device_count())))
        return 0


def _require_port():
    import densityflows_tpu_torch

    path = os.path.abspath(densityflows_tpu_torch.__file__)
    if not path.startswith(ROOT + os.sep):
        raise ImportError(f"densityflows_tpu_torch comes from {path}, not "
                          f"from this checkout ({ROOT})")


def execute(manifest, workload: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, *, err=None, overrides=None) -> dict:
    """Run the cell and build the result line (without printing it).
    ``overrides``: ``{"config": {...}, "traffic": {...}}`` merged into the
    files' top-level keys (the tests' small sizes)."""
    from perfbench.check import judge
    from perfbench.manifest import load_reader

    cell = manifest.cell(workload)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    for key, target in (("config", cfg), ("traffic", traffic)):
        for k, v in (overrides or {}).get(key, {}).items():
            target[k] = v
    ctx = Context(cfg, traffic, seed, seconds, trace, device, t_start, err)
    res = manifest.generator(traffic).run(ctx)

    metrics = {}
    if trace:
        sl = res["slice"]
        for m in manifest.per_layer(workload):
            value = load_reader(m["name"]).read(sl)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(workload):
            if m["name"] not in res["metrics"]:
                raise RuntimeError(f"the generator gave no {m['name']}")
            metrics[m["name"]] = {"value": float(res["metrics"][m["name"]]),
                                  "unit": m["unit"]}
    ok, checks = judge(res["checks"], manifest.limits(workload))
    correct = ok and res["failed"] == 0 and res["attempted"] > 0
    dev = {"platform": "gpu", "kind": None, "count": int(cell["chips"]),
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if str(device).startswith("cuda"):
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res["slice"].busy_s()
        dev["window_s"] = res["slice"].window_s
        line["breakdown"] = res["slice"].breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _require_port()
    line = execute(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
