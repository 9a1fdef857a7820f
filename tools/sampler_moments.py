#!/usr/bin/env python3
"""Moments of the ``chain_sample`` kernel's draws on one NVIDIA GPU.

    python3 tools/sampler_moments.py

On the flagship split chain of ``chip_smoke.py``'s inference phase (d 32,
n 8, 8 RealNVP couplings of hidden 256, normalization; one θ), 32 launches
of 2^18 rows, each from its own seed:

- the in-kernel N(0, I) draws (``return_noise=True``): the largest
  |column mean| over its standard error and |column variance − 1| over its
  standard error, over all 2^23 rows;
- the samples against the per-layer sampler (``torch.randn`` on the card and
  the per-layer forward sweep, as many rows): the largest z of the column
  means' difference and the largest |std ratio − 1|;
- per launch, that z for 2^18 rows each: the spread of the statistic
  ``chip_smoke.py``'s moment gates read.

Prints one line per measurement. Exits non-zero without CUDA.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import densityflows_tpu_torch as dt  # noqa: E402
from densityflows_tpu_torch import _build  # noqa: E402
from densityflows_tpu_torch.models import fused_chain as fc  # noqa: E402
from densityflows_tpu_torch.ops import chain_kernels as ck  # noqa: E402

LAUNCHES = 32


class Moments:
    def __init__(self):
        self.s = self.ss = 0.0
        self.n = 0

    def add(self, a):
        a = a.double()
        self.s = self.s + a.sum(0)
        self.ss = self.ss + (a * a).sum(0)
        self.n += a.shape[0]

    def mean_var(self):
        m = self.s / self.n
        return m, self.ss / self.n - m * m


def main():
    if not torch.cuda.is_available():
        print("sampler_moments: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.device_line(), flush=True)
    _build.load_libraries(["chain_kernels"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 61)
    chain = cs.wide_chain(False, rng, dev)
    meta, _, _, theta = cs.flagship_inputs(rng, cs.N_COND, 16, dev,
                                           "inference")
    flow = dt.Flow(chain, meta, device=dev)
    th1 = flow.prepare_theta(theta, (1,)).contiguous()
    plan, params = fc._plan_params(chain, "fwd")
    packed = ck.pack_plan(plan, params, cs.D, cs.N_COND)
    rows = cs.ROWS
    noise_m, y_m, plain_m = Moments(), Moments(), Moments()
    per_launch = []
    for s in range(LAUNCHES):
        y, noise = ck.run_chain_sample(plan, params, rows, cs.D, th1,
                                       seed=1000 + s, packed=packed,
                                       return_noise=True)
        with torch.no_grad(), cs.kernel_policy(False):
            p = flow.sample((rows,), theta, generator=torch.Generator(
                device=dev).manual_seed(5000 + s))
        noise_m.add(noise)
        y_m.add(y)
        plain_m.add(p)
        z = ((y.double().mean(0) - p.double().mean(0)).abs()
             / torch.sqrt(p.double().var(0) * 2 / rows)).max()
        per_launch.append(round(float(z), 2))
    m, v = noise_m.mean_var()
    n = noise_m.n
    print(f"noise: {n} rows, max |mean| z {float((m.abs() * n**0.5).max())}, "
          f"max |var - 1| / se {float(((v - 1).abs() / (2 / n)**0.5).max())}")
    my, vy = y_m.mean_var()
    mp, vp = plain_m.mean_var()
    z = (my - mp).abs() / torch.sqrt((vy + vp) / n)
    ratio = (vy.sqrt() / vp.sqrt() - 1).abs().max()
    print(f"samples vs per-layer sampler, {n} rows each: max z "
          f"{float(z.max())}, std ratio err {float(ratio)}")
    print(f"per launch of {rows} rows, max z: {per_launch}, median "
          f"{float(np.median(per_launch))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
