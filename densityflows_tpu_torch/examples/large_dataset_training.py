"""Worked example: training at data set scale with the route made visible.

Counterpart of ``examples/large_dataset_training.py``: a conditional flow on
60,000 rows, three epochs at batch 64. Every ``train()`` call records the
path it ran: on a CUDA device the whole-run kernel (``trained_path ==
"fused"``, ``fused_kernel_mode`` ``"resident"`` for one ``train_run``
launch, ``"stream"`` for ``train_stream``), on the CPU the plain program
with the reason recorded.

Run: python -m densityflows_tpu_torch.examples.large_dataset_training
"""

import numpy as np
import torch

import densityflows_tpu_torch as dt


def simulate(n, rng):
    theta = rng.uniform(-1.0, 2.0, size=(n, 1)).astype(np.float32)
    x1 = rng.normal(size=n)
    x2 = np.sin(x1 / 0.8) + 0.3 * rng.normal(size=n) + theta[:, 0]
    x3 = np.cos(x1 / 1.1) + 0.3 * rng.normal(size=n) - 0.2 * theta[:, 0]
    x = np.stack([x1, x2, x3], axis=1).astype(np.float32)
    return x, theta


def main(device=None):
    device = dt.resolve_device(device)
    rng = np.random.default_rng(0)
    x, theta = simulate(60_000, rng)
    data = dt.DataArrays.make(x, theta, rng=0)

    kw = dict(hidden_dim_s=16, hidden_dim_t=16,
              generator=torch.Generator().manual_seed(0), device=device)
    chain = dt.flow_chain(
        dt.coupling_layer(data, [0, 1], **kw),
        dt.coupling_layer(data, [1, 2], **kw),
        dt.normalization_layer(x, -1.0, 1.0, device=device),
    )
    flow = dt.Flow(chain, data, device=device)

    # verbose=True prints a one-line notice if the kernel declines (and
    # which envelope item blocked it)
    dt.train(flow, data, dt.adam(1e-3), epochs=3, batchsize=64,
             verbose=True, generator=torch.Generator().manual_seed(1))

    print(f"trained_path      = {flow.trained_path}")
    print(f"fused_kernel_mode = {flow.fused_kernel_mode}")
    print(f"decline reason    = {flow.fused_decline_reason}")
    print(f"final valid NLL   = {flow.valid_loss[-1]:.3f}")

    s = flow.sample((10_000,), (0.5,),
                    generator=torch.Generator().manual_seed(2))
    mean = s.mean(0).detach().cpu().numpy()
    print(f"10k conditional draws at theta=0.5: mean {mean.round(3)}")
    return dict(trained_path=flow.trained_path,
                fused_kernel_mode=flow.fused_kernel_mode,
                decline_reason=flow.fused_decline_reason,
                valid_nll=flow.valid_loss[-1], sample_mean=mean.tolist())


if __name__ == "__main__":
    from ._cli import run

    run(main, __doc__)
