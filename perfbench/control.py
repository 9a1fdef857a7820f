"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the nearest precision below float32 (TF32
products), on the inputs a run of each seed checks, at the cell's own sizes.
Each of its numbers has to read over its limit on some number of the cell.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed with the control's numbers and the limits.
The benchmark's runs never run this; ``tests/test_pb_control.py`` does, on a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(manifest, workload: str, seed: int, device,
                     fault: str = "tf32") -> dict:
    from perfbench.run import Context

    cell = manifest.cell(workload)
    cfg = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    ctx = Context(cfg, traffic, seed, 0.0, False, device, time.time())
    return manifest.generator(traffic).control_gaps(ctx, fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="tf32",
                    choices=("tf32", "half_batch", "unchanged"),
                    help="training cells: a fault planted in the reference "
                         "instead of the lower precision")
    args = ap.parse_args(argv)

    import torch

    from perfbench.manifest import Manifest

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    limits = manifest.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        gaps = control_readings(manifest, args.workload, seed, "cuda",
                                args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "control": gaps,
                          "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
