"""2-D toy densities: unconditional 8-layer coupling stacks.

Counterpart of ``examples/toy_densities.py`` (BASELINE.json config 2):
4 complementary coupling blocks of hidden 48 and a normalization layer,
trained on two-moons with RealNVP couplings and on concentric rings with
rational-quadratic spline couplings; reports the NLL, the share of draws
within 3σ of the true manifold and the data-vs-background log-prob
contrast.

Run: python -m densityflows_tpu_torch.examples.toy_densities
     [--dataset moons|rings|both] [--epochs 60]
"""

import numpy as np
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.utils.datasets import (
    moons_manifold_distance,
    rings,
    rings_manifold_distance,
    two_moons,
)


def run(name: str, epochs: int, device):
    if name == "moons":
        noise = 0.1
        x = two_moons(4000, noise=noise, rng=0)
        kind, dist = dt.RNVPCouplingLayer, moons_manifold_distance
    else:
        noise = 0.08
        x = rings(4000, noise=noise, rng=0)
        kind, dist = dt.RQSCouplingLayer, rings_manifold_distance

    data = dt.DataArrays.make(x, rng=0)
    g = torch.Generator().manual_seed(0)
    blocks = [dt.coupling_block(2, [0], kind=kind, generator=g,
                                hidden_dim_s=48, hidden_dim_t=48,
                                device=device) for _ in range(4)]
    chain = dt.flow_chain(*blocks,
                          dt.normalization_layer(x, -1.0, 1.0, device=device))
    flow = dt.Flow(chain, data, device=device)
    dt.train(flow, data, dt.adam(2e-3), epochs=epochs, batchsize=256,
             verbose=False, generator=torch.Generator().manual_seed(1))

    s = flow.sample((4000,),
                    generator=torch.Generator().manual_seed(2)).detach().cpu().numpy()
    cover = float(np.mean(dist(s) < 3 * noise))
    lo, hi = x.min(0), x.max(0)
    bg = np.random.default_rng(3).uniform(
        lo, hi, size=(2000, 2)).astype(np.float32)
    lp_data = float(flow.log_prob(x[:1000]).detach().mean())
    lp_bg = float(flow.log_prob(bg).detach().mean())
    print(f"{name:6s} [{kind.__name__}]  "
          f"train NLL {flow.train_loss[-1]:.3f} | valid NLL "
          f"{flow.valid_loss[-1]:.3f} | {cover:.1%} of samples within "
          f"3σ of the manifold | log p: data {lp_data:.2f} vs "
          f"background {lp_bg:.2f}")
    return dict(train_nll=flow.train_loss[-1], cover=cover,
                lp_data=lp_data, lp_background=lp_bg,
                trained_path=flow.trained_path)


def main(device=None, dataset: str = "both", epochs: int = 60):
    device = dt.resolve_device(device)
    names = ["moons", "rings"] if dataset == "both" else [dataset]
    return {name: run(name, epochs, device) for name in names}


if __name__ == "__main__":
    from ._cli import run as cli

    cli(main, __doc__, dataset=(str, "both"), epochs=(int, 60))
