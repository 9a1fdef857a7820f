"""Worked example: 5-D conditional density estimation (docs/example.md).

Counterpart of ``examples/conditional_density.py``: three RealNVP couplings
of hidden 16 and a normalization layer, 50 epochs of Adam at batch 64 (on a
CUDA device one ``train_run`` launch), then 50,000 conditional draws at
θ = −1 against the data's moments.

Run: python -m densityflows_tpu_torch.examples.conditional_density
"""

import numpy as np
import torch

import densityflows_tpu_torch as dt


def simulate(theta, n, rng):
    x1 = rng.normal(size=n)
    eps = lambda: rng.normal(size=n)  # noqa: E731
    x2 = np.sin(x1 / 0.8) + 0.3 * eps() + theta
    x3 = np.exp(x1 / 1.4) / 10 + 0.1 * theta * eps() - 0.1 * theta
    x4 = np.cos(x1 / 1.1) + 0.3 * eps() + theta
    x5 = rng.normal(size=n)
    return np.stack([x1, x2, x3, x4, x5], axis=1).astype(np.float32)


def main(device=None):
    device = dt.resolve_device(device)
    rng = np.random.default_rng(0)
    x = np.concatenate([simulate(-1.0, 2000, rng), simulate(2.0, 2000, rng)])
    theta = np.concatenate(
        [np.full((2000, 1), -1.0), np.full((2000, 1), 2.0)]
    ).astype(np.float32)
    data = dt.DataArrays.make(x, theta, rng=0)

    kw = dict(hidden_dim_s=16, hidden_dim_t=16,
              generator=torch.Generator().manual_seed(0), device=device)
    chain = dt.flow_chain(
        dt.coupling_layer(data, [0, 1, 2], **kw),
        dt.coupling_layer(data, [2, 3, 4], **kw),
        dt.coupling_layer(data, [4, 0, 1], **kw),
        dt.normalization_layer(x, -1.0, 1.0, device=device),
    )
    flow = dt.Flow(chain, data, device=device)
    dt.train(flow, data, epochs=50, verbose=False,
             generator=torch.Generator().manual_seed(1))
    print(f"final NLL: train {flow.training_loss[-1]:.3f} "
          f"valid {flow.validation_loss[-1]:.3f} ({flow.trained_path})")

    s = flow.sample((50_000,), (-1.0,),
                    generator=torch.Generator().manual_seed(2)).detach().cpu().numpy()
    ref = x[theta[:, 0] == -1.0]
    print("dim |  data mean  model mean |  data std  model std")
    for i in range(5):
        print(f"  {i} | {ref[:, i].mean():+10.3f} {s[:, i].mean():+10.3f} "
              f"| {ref[:, i].std():9.3f} {s[:, i].std():9.3f}")
    return dict(train_nll=flow.training_loss[-1],
                valid_nll=flow.validation_loss[-1],
                trained_path=flow.trained_path,
                mean_abs_diff=float(np.abs(ref.mean(0) - s.mean(0)).max()),
                samples=s.shape)


if __name__ == "__main__":
    from ._cli import run

    run(main, __doc__)
