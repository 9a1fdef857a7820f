"""Worked example: simulation-based inference (SNPE) + SMC cross-check.

Counterpart of ``examples/sbi_posterior.py``: an amortized posterior
q(θ | x) for a toy simulator with a spline flow (``fit_posterior``), the
same fit with the atomic APT objective (``fit_posterior_apt``), and the
posterior at one observation against tempered SMC on the analytic
unnormalized posterior (``run_smc``).

Run: python -m densityflows_tpu_torch.examples.sbi_posterior
"""

import numpy as np
import torch

import densityflows_tpu_torch as dt

SIGMA = 0.2


def _spline_flow(x, seed, device):
    chain = dt.flow_chain(dt.coupling_layer(
        1, [0], n=1, kind=dt.RQSCouplingLayer, hidden_dim_t=32, n_bins=8,
        generator=torch.Generator().manual_seed(seed), device=device))
    return dt.Flow(chain, dt.MetaData("", 1, 1, x.min(0), x.max(0)),
                   device=device)


def main(device=None):
    device = dt.resolve_device(device)
    rng = np.random.default_rng(0)
    n_sims = 5000
    theta = rng.uniform(-1.0, 1.0, size=(n_sims, 1)).astype(np.float32)
    x = (np.sin(2 * theta)
         + SIGMA * rng.normal(size=(n_sims, 1))).astype(np.float32)

    # amortized posterior: a flow over θ conditioned on x
    flow = _spline_flow(x, 0, device)
    dt.fit_posterior(flow, theta, x, epochs=60,
                     generator=torch.Generator().manual_seed(1))
    x_obs = 0.5
    post = flow.sample((20_000,), (x_obs,),
                       generator=torch.Generator().manual_seed(2))
    post = post.detach().cpu().numpy()
    print(f"SNPE posterior at x={x_obs}: mean {post.mean():+.3f} "
          f"std {post.std():.3f}")

    # the atomic SNPE-C / APT objective; the prior is Uniform(-1, 1)
    flow_apt = _spline_flow(x, 5, device)
    dt.fit_posterior_apt(
        flow_apt, theta, x, lambda t: np.full(len(t), -np.log(2.0)),
        n_atoms=10, epochs=60, batchsize=128,
        generator=torch.Generator().manual_seed(6))
    post_apt = flow_apt.sample(
        (20_000,), (x_obs,),
        generator=torch.Generator().manual_seed(7)).detach().cpu().numpy()
    print(f"APT  posterior at x={x_obs}: mean {post_apt.mean():+.3f} "
          f"std {post_apt.std():.3f}")

    # SMC on the analytic unnormalized posterior p(θ|x) ∝ p(x|θ)·1[|θ|≤1]
    def log_post(th):
        ll = -0.5 * torch.sum((x_obs - torch.sin(2 * th)) ** 2, -1) \
            / SIGMA ** 2
        inside = torch.all(torch.abs(th) <= 1.0, dim=-1)
        return torch.where(inside, ll, torch.full_like(ll, -1e9))

    particles, log_w, _ = dt.run_smc(
        log_post, d=1, n_particles=8192, n_steps=20, init_scale=1.0,
        mh_step_size=0.2, n_mh=3,
        generator=torch.Generator().manual_seed(3), device=device)
    lw = log_w.detach().cpu().numpy().astype(np.float64)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    p = particles.detach().cpu().numpy()[:, 0]
    mean = float((p * w).sum())
    std = float(np.sqrt(((p - mean) ** 2 * w).sum()))
    print(f"SMC  posterior at x={x_obs}: mean {mean:+.3f} std {std:.3f}")
    return dict(snpe=(float(post.mean()), float(post.std())),
                apt=(float(post_apt.mean()), float(post_apt.std())),
                smc=(mean, std))


if __name__ == "__main__":
    from ._cli import run

    run(main, __doc__)
