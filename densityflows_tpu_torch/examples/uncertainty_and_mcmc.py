"""Worked example: deep-ensemble density fit + flow-accelerated MCMC + SBC.

Counterpart of ``examples/uncertainty_and_mcmc.py``:

1. trains a 5-member ensemble on a bimodal 2-D target (``train_ensemble``)
   and reads epistemic uncertainty off the member spread;
2. uses one member as the proposal of independence-MH MCMC on the exact
   unnormalized target (``flow_mcmc``) and compares moments;
3. runs a simulation-based-calibration check on an amortized posterior
   (``fit_posterior``, ``sbc_ranks``, ``sbc_uniformity``).

The members hold an invertible linear layer, whose LU pivots are static
structure: the factory builds it from one generator seeded alike for every
member, as the JAX example shares its key. The layer is outside the
whole-run kernel's envelope, so the ensemble trains on the plain program
(the decline is recorded on the members).

Run: python -m densityflows_tpu_torch.examples.uncertainty_and_mcmc
"""

import warnings

import numpy as np
import torch

import densityflows_tpu_torch as dt


def make_target_data(rng, n):
    comp = rng.integers(0, 2, size=n)
    centers = np.where(comp[:, None] == 0, [-2.0, 0.0], [2.0, 1.0])
    return (centers + 0.5 * rng.normal(size=(n, 2))).astype(np.float32)


def target_logp(x):
    def mode(x, mu):
        u = (x - torch.as_tensor(mu, dtype=x.dtype, device=x.device)) / 0.5
        return -0.5 * torch.sum(u * u, dim=-1)

    return torch.logaddexp(mode(x, [-2.0, 0.0]), mode(x, [2.0, 1.0]))


def main(device=None):
    device = dt.resolve_device(device)
    rng = np.random.default_rng(0)
    x = make_target_data(rng, 4000)
    data = dt.DataArrays.make(x, rng=0)

    # -- 1. deep ensemble ---------------------------------------------------
    def factory(generator):
        kw = dict(hidden_dim_s=64, hidden_dim_t=64, device=device,
                  generator=generator)
        return dt.flow_chain(
            dt.coupling_layer(2, [0], **kw),
            # static LU pivots must match across members: a shared seed
            dt.invertible_linear_layer(
                2, generator=torch.Generator().manual_seed(7), device=device),
            dt.coupling_layer(2, [1], **kw),
            dt.actnorm_layer(x, device=device),
        )

    with warnings.catch_warnings():
        # the decline is recorded on the members and printed below
        warnings.simplefilter("ignore", RuntimeWarning)
        ens = dt.train_ensemble(factory, data, n_members=5, epochs=40,
                                generator=torch.Generator().manual_seed(1),
                                verbose=False, device=device)
    tls = np.asarray(ens.train_loss)
    print(f"ensemble final NLL per member: {np.round(tls[-1], 3)} "
          f"({ens.trained_path[0]}: {ens.fused_decline_reason[0]})")

    grid = np.stack(np.meshgrid(np.linspace(-4, 4, 40),
                                np.linspace(-3, 4, 40)), -1).reshape(-1, 2)
    lp_m = ens.log_prob_members(grid.astype(np.float32)).detach().cpu().numpy()
    spread = lp_m.std(axis=0)
    print(f"epistemic spread: mean {spread.mean():.3f}, "
          f"max {spread.max():.3f} (largest off-support, as expected)")

    # -- 2. flow-proposal MCMC on the exact target --------------------------
    member = ens.member(0)
    samples, diag = dt.flow_mcmc(member, target_logp, n_chains=256,
                                 n_steps=800, burn_in=200,
                                 generator=torch.Generator().manual_seed(2))
    s = samples.reshape(-1, 2).detach().cpu().numpy()
    acc = float(diag["accept_rate"].mean())
    print(f"independence-MH acceptance {acc:.2f} (fit quality); "
          f"MCMC mean {np.round(s.mean(0), 3)} vs target [0, 0.5]")

    # -- 3. SBC on an amortized posterior -----------------------------------
    n_sims = 400
    theta = rng.normal(size=(n_sims, 1)).astype(np.float32)
    obs = (theta + 0.3 * rng.normal(size=(n_sims, 1))).astype(np.float32)
    post = dt.Flow(
        dt.flow_chain(dt.coupling_layer(
            1, [0], n=1, kind=dt.RQSCouplingLayer, n_bins=8,
            generator=torch.Generator().manual_seed(3), device=device)),
        dt.MetaData("", 1, 1, obs.min(0), obs.max(0)), device=device)
    dt.fit_posterior(post, theta, obs, epochs=60,
                     generator=torch.Generator().manual_seed(4))
    ranks = dt.sbc_ranks(post, theta, obs, n_draws=128,
                         generator=torch.Generator().manual_seed(5))
    ks = dt.sbc_uniformity(ranks, 128)
    print(f"SBC KS distance {ks:.3f} "
          f"(calibrated if < {1.63 / np.sqrt(n_sims):.3f} at the 1% level)")
    return dict(final_nll=tls[-1].tolist(), spread_mean=float(spread.mean()),
                spread_max=float(spread.max()), accept_rate=acc,
                mcmc_mean=s.mean(0).tolist(), sbc_ks=float(ks),
                trained_path=ens.trained_path[0],
                decline_reason=ens.fused_decline_reason[0])


if __name__ == "__main__":
    from ._cli import run

    run(main, __doc__)
