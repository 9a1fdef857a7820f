"""Inference engine: rejection sampling, SNPE / VI posterior fitting, SMC,
flow-accelerated MCMC and simulation-based calibration.

PyTorch counterpart of ``densityflows_tpu/inference.py``, with the same
public names:

- :func:`sample_with_rejection` — fixed-size draw rounds through the flow's
  ldj-free sweep, the accepted rows of each round kept in draw order until
  ``n_samples`` are filled, capped at ``max_rounds`` rounds;
- :func:`weighted_nll_loss` / :func:`make_weighted_train_step` — the
  importance-weighted NLL and its Adam step;
- :func:`fit_posterior` — the amortized posterior q(θ | x) by conditional
  MLE through ``train`` (the whole-run kernel on a CUDA flow), with optional
  SNPE-B importance weights; :func:`fit_posterior_rounds` (sequential SNPE-B
  or APT), :func:`propose_from_posterior`, :func:`fit_posterior_apt` /
  :func:`apt_loss` (the atomic SNPE-C loss);
- :func:`fit_variational` — the reparameterized reverse-KL fit;
- :func:`effective_sample_size`, :func:`systematic_resample`,
  :class:`SMCState`, :func:`smc_step`, :func:`run_smc` — tempered SMC;
- :func:`flow_mcmc` with :func:`mcmc_diagnostics` (split-R̂, ESS), and
  :func:`sbc_ranks` / :func:`sbc_uniformity`.

Every entry point runs on the flow's device (``run_smc``, which has no flow,
on ``device``; ``None`` means ``"cuda"``). Where the JAX package takes a
``key`` the port takes ``generator``, a ``torch.Generator`` (None: torch's
global generator); the draws are deterministic in the generator's state and
are a different stream from JAX's. Inputs and outputs are float32 tensors,
except for the numpy diagnostics and the host-side SNPE plumbing, which
take and return numpy arrays as in JAX.

``mesh=`` (a ``parallel.mesh.Mesh``) on ``sample_with_rejection``,
``fit_variational``, ``run_smc`` and ``flow_mcmc`` splits the candidate,
particle or chain axis over the mesh's ``data`` axis
(``parallel.mesh.host_local_rows``): each rank folds its rows through the
flow, the reductions over the axis (acceptance counts, ESS and its sums,
the variational loss and gradients) are all-reduced, SMC resamples with the
ring resampler ``parallel.resample.systematic_resample_sharded``, and every
rank returns the whole result. Every rank passes the same arguments and an
equally seeded generator: each draw is made whole on every rank (the
one-process stream) and each rank takes its rows of it, so a run equals the
one-process run of the same generator state up to the order of the sums.
``fit_posterior(mesh=...)`` is the data-parallel ``train(mesh=...)``.

Not ported: ``clear_caches`` and ``trace_counts`` (the JAX engine caches
its jitted programs by the identity of their Python objects; eager PyTorch
has no program to cache).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ._device import as_float32, resolve_device
from .models.flow import Flow, _chain_eval
from .models.fused_train import trainable_leaves
from .data import DataArrays, normalize_input
from .parallel.mesh import check_mesh, host_local_rows
from .train import Adam, _autograd, _reduce_grads, train

__all__ = [
    "sample_with_rejection",
    "weighted_nll_loss",
    "make_weighted_train_step",
    "fit_posterior",
    "fit_posterior_apt",
    "apt_loss",
    "fit_posterior_rounds",
    "propose_from_posterior",
    "fit_variational",
    "effective_sample_size",
    "systematic_resample",
    "SMCState",
    "smc_step",
    "run_smc",
    "flow_mcmc",
    "mcmc_diagnostics",
    "sbc_ranks",
    "sbc_uniformity",
]


# -- the particle axis under a mesh -----------------------------------------------

def _share(mesh, n: int) -> slice:
    """This rank's rows of an axis of ``n`` rows (all of them without a
    mesh)."""
    return slice(0, n) if mesh is None else host_local_rows(mesh, n)


def _whole(mesh, local, n: int):
    """The ``n`` rows of every rank's share, on every rank."""
    return local if mesh is None else mesh.all_gather_rows(local, n)


# -- where the random numbers come from ----------------------------------------

class _Draws:
    """The random numbers of an entry point, in the order the JAX program
    draws them: each method is one draw from ``generator`` (on the
    generator's device, then moved to ``device``). Tests replace it with a
    source that hands out the JAX program's own draws in the same order."""

    def __init__(self, generator, device):
        self.generator = generator
        self.device = torch.device(device)
        self._gen_device = (generator.device if generator is not None
                            else self.device)

    def base(self, base, shape):
        """``base.sample`` of ``shape`` rows: (*shape, d)."""
        return base.sample(self.generator, tuple(shape), self.device)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self._gen_device).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self._gen_device).to(self.device)

    def permutation(self, n):
        return torch.randperm(n, generator=self.generator,
                              device=self._gen_device).to(self.device)

    def atoms(self, b, n_atoms):
        return _atom_indices(self.generator, b, n_atoms,
                             self._gen_device).to(self.device)


def _adam_step(model, optimizer, opt_state, loss_fn, mesh=None):
    """One optimizer step on ``loss_fn()``'s autograd gradients, the model's
    trainable leaves updated in place; with a ``mesh`` the loss and the
    gradients are summed over its ``data`` axis first. Returns the new state
    and the detached loss."""
    loss, leaves, grads = _autograd(model, loss_fn)
    if mesh is not None:
        loss, leaves, grads = _reduce_grads(mesh, loss, leaves, grads)
    updates, opt_state = optimizer.update(grads, opt_state, leaves)
    with torch.no_grad():
        torch._foreach_add_(leaves, list(updates))
    return opt_state, loss


# -- rejection sampling -----------------------------------------------------


def sample_with_rejection(
    flow: Flow,
    n_samples: int,
    condition: Callable[[torch.Tensor], torch.Tensor],
    theta=None,
    *,
    generator=None,
    max_rounds: int = 100,
    batch: int | None = None,
    mesh=None,
    _draws=None,
):
    """Draw ``n_samples`` samples satisfying ``condition(x) -> bool mask``.

    Each round draws ``batch`` candidates from the base and sends them
    through the flow's ldj-free sweep (``FlowChain.forward_``: one
    ``chain_apply`` launch on a CUDA device for a fusable chain); the
    accepted rows of the round fill the output in draw order, and rows past
    ``n_samples`` are dropped. Raises ``RuntimeError`` if ``max_rounds``
    rounds accept fewer than ``n_samples`` rows.

    ``mesh``: each round's candidates are split over the ``data`` axis;
    each rank folds and tests its rows, and the rows and their verdicts are
    gathered in global row order before the accepted ones fill the output.
    """
    check_mesh(mesh)
    if batch is None:
        batch = max(2 * n_samples, 1024)
    draws = _draws if _draws is not None else _Draws(generator, flow.device)
    rows = _share(mesh, batch)
    theta_n = flow.prepare_theta(theta, (batch,))[rows]
    out = torch.empty((n_samples, flow.metadata.d), device=flow.device)
    filled = rounds = 0
    with torch.no_grad():
        while filled < n_samples and rounds < max_rounds:
            r = draws.base(flow.base, (batch,))[rows]
            x = flow.model.forward_(r, theta_n)
            ok = condition(x).reshape(-1).to(torch.bool)
            if mesh is not None:
                x = _whole(mesh, x, batch)
                ok = _whole(mesh, ok.to(torch.float32), batch) > 0.5
            accepted = x[ok]
            take = min(accepted.shape[0], n_samples - filled)
            out[filled:filled + take] = accepted[:take]
            filled += take
            rounds += 1
    if filled < n_samples:
        raise RuntimeError(
            f"rejection sampling accepted only {filled}/{n_samples} draws "
            f"after {rounds} rounds of {batch} "
            "(reference convergence-cap contract, src/Flows.jl:220-223)"
        )
    return out


# -- importance-weighted NLL ------------------------------------------------


def weighted_nll_loss(model, base, x, theta, weights):
    """−Σ wᵢ·log p(xᵢ|θᵢ) / Σ wᵢ — importance-weighted forward-KL NLL.

    With ``weights = prior(θ)/proposal(θ)`` this is the SNPE-B correction;
    with uniform weights it is the plain NLL."""
    z, ldj = model.inverse(x, theta)
    per_sample = base.log_prob(z) + ldj
    w = weights.to(torch.float32)
    return -(per_sample * w).sum() / torch.clamp(w.sum(), min=1e-30)


def make_weighted_train_step(optimizer):
    """Loss + gradient + update step for :func:`weighted_nll_loss`:
    ``step(model, opt_state, base, x, theta, weights) → (model, opt_state,
    loss)``, the model updated in place (the weighted analogue of
    ``train.make_train_step``)."""

    def step(model, opt_state, base, x, theta, weights):
        opt_state, loss = _adam_step(
            model, optimizer, opt_state,
            lambda: weighted_nll_loss(model, base, x, theta, weights))
        return model, opt_state, loss

    return step


# -- SNPE-style amortized posterior fit -------------------------------------


def fit_posterior(
    flow: Flow,
    theta_samples,
    x_observations,
    *,
    weights=None,
    optimizer=None,
    epochs: int = 100,
    batchsize: int = 64,
    generator=None,
    mesh=None,
    verbose: bool = False,
    _epoch_perms=None,
):
    """Fit the flow as an amortized posterior q(θ | x) by conditional MLE.

    The flow's *data* axis models θ and its *condition* axis models x. Pass
    ``weights = prior(θᵢ)/proposal(θᵢ)`` when θ was drawn from a proposal
    instead of the prior (the SNPE-B correction). Both forms run ``train``
    on ``DataArrays.make(θ, x, rng=0)``: on a CUDA flow the whole-run kernel
    (weights are its per-row loss weights), with ``mesh`` the data-parallel
    program. Returns ``train``'s optimizer state.
    """
    theta_samples = np.asarray(theta_samples, np.float32)
    x_observations = np.asarray(x_observations, np.float32)
    data = DataArrays.make(theta_samples, x_observations, rng=0)
    return train(
        flow, data, optimizer, epochs=epochs, batchsize=batchsize,
        generator=generator, mesh=mesh, verbose=verbose, weights=weights,
        _epoch_perms=_epoch_perms,
    )


def _eps_generator(generator, device):
    """The independent stream of the ε batch: a new generator on the same
    device as ``generator`` (the flow's device without one), seeded with one
    63-bit draw from ``generator`` XOR 0xE95."""
    gen_device = generator.device if generator is not None else device
    seed = int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=gen_device))
    return torch.Generator(device=gen_device).manual_seed(seed ^ 0xE95)


def propose_from_posterior(
    flow,
    x_obs,
    n: int,
    prior_sample: Callable[[np.random.Generator, int], np.ndarray],
    prior_log_prob: Callable[[np.ndarray], np.ndarray],
    rng: np.random.Generator,
    generator=None,
    *,
    n_eps_min: int = 4096,
):
    """Draw n proposal θ from the posterior estimate q(θ | x_obs), with
    prior-support fallback, and return (θ, log q̃(θ)) as numpy arrays under
    the TRUE proposal density.

    θ ~ flow; a θ outside the prior support (``prior_log_prob = −inf``) is
    replaced by a prior draw. The density of this mechanism at in-support θ
    is the mixture q̃(θ) = q_flow(θ) + ε·prior(θ), ε = P_flow(draw ∉
    support). ε is estimated from an independent batch of ≥ ``n_eps_min``
    flow draws, add-one smoothed. That batch is drawn from a second
    generator seeded from ``generator`` after the proposal draw (one 63-bit
    draw XOR 0xE95), the port's rule for JAX's ``fold_in(key, 0xE95)``.

    On a CUDA flow the draws are one ``chain_sample`` launch and log q_flow
    one ``chain_apply`` launch.
    """
    x_obs = np.asarray(x_obs, np.float32).reshape(-1)
    cond = tuple(float(v) for v in x_obs)
    draws = np.array(_host(flow.sample((n,), cond, generator=generator)),
                     np.float32)
    lp_prior = np.asarray(prior_log_prob(draws), np.float64)
    bad = ~np.isfinite(lp_prior)
    if bad.any():
        draws[bad] = np.asarray(prior_sample(rng, int(bad.sum())), np.float32)
    theta = draws
    cond_b = np.ascontiguousarray(
        np.broadcast_to(x_obs, (len(theta), x_obs.shape[0])))
    log_q_flow = np.asarray(_host(flow.log_prob(theta, cond_b)), np.float64)
    if not bad.any():
        return theta, log_q_flow
    n_eps = max(n, n_eps_min)
    g_eps = _eps_generator(generator, getattr(flow, "device", "cpu"))
    eps_draws = np.asarray(
        _host(flow.sample((n_eps,), cond, generator=g_eps)), np.float32)
    n_bad = int(
        (~np.isfinite(np.asarray(prior_log_prob(eps_draws), np.float64))).sum()
    )
    eps = max(n_bad, 1) / (n_eps + 1)
    log_q = np.logaddexp(
        log_q_flow,
        np.log(eps) + np.asarray(prior_log_prob(theta), np.float64),
    )
    return theta, log_q


def _host(a):
    """A tensor (or array) as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fit_posterior_rounds(
    flow: Flow,
    simulator: Callable[[np.ndarray], np.ndarray],
    prior_sample: Callable[[np.random.Generator, int], np.ndarray],
    prior_log_prob: Callable[[np.ndarray], np.ndarray],
    x_obs,
    *,
    n_rounds: int = 3,
    n_sims_per_round: int = 1000,
    optimizer=None,
    epochs: int = 50,
    batchsize: int = 64,
    generator=None,
    rng=None,
    verbose: bool = False,
    method: str = "snpe_b",
    n_atoms: int = 10,
):
    """Sequential (multi-round) SNPE: simulate → fit → propose, focused on
    one observation ``x_obs``.

    ``method``: ``"snpe_b"`` (importance-weighted NLL with the exact mixture
    proposal density of :func:`propose_from_posterior`) or ``"apt"`` (the
    atomic loss of :func:`fit_posterior_apt` with ``n_atoms``; the history
    reports the weight ESS as ``None``).

    Round 1 draws θ from the prior; later rounds draw from the current
    posterior estimate q(θ | x_obs), and SNPE-B weights w = p(θ)/q̃(θ |
    x_obs) keep the fit on the true posterior. Simulation runs on the host
    (``simulator`` is user code on numpy arrays); fitting is
    :func:`fit_posterior` (the whole-run kernel on a CUDA flow). Proposals
    and fits draw from ``generator`` in turn; ``rng`` (numpy, default seed
    0) feeds ``prior_sample``.

    Returns ``(flow, history)``: per round its number, the simulations so
    far and the ESS of the importance weights.
    """
    if method not in ("snpe_b", "apt"):
        raise ValueError("method must be 'snpe_b' or 'apt'")
    if rng is None:
        rng = np.random.default_rng(0)
    x_obs = np.asarray(x_obs, np.float32).reshape(-1)

    all_theta: list[np.ndarray] = []
    all_x: list[np.ndarray] = []
    all_logq: list[np.ndarray] = []  # log proposal density at each θ
    history = []

    for rnd in range(n_rounds):
        if rnd == 0:
            theta = np.asarray(prior_sample(rng, n_sims_per_round), np.float32)
            log_q = np.asarray(prior_log_prob(theta), np.float64)
        else:
            theta, log_q = propose_from_posterior(
                flow, x_obs, n_sims_per_round, prior_sample,
                prior_log_prob, rng, generator,
            )
        x_sim = np.asarray(simulator(theta), np.float32)
        if x_sim.shape[0] != theta.shape[0]:
            raise ValueError("simulator must return one row per θ")

        all_theta.append(theta)
        all_x.append(x_sim)
        all_logq.append(log_q)

        theta_cat = np.concatenate(all_theta)
        x_cat = np.concatenate(all_x)

        if method == "apt":
            fit_posterior_apt(
                flow, theta_cat, x_cat, prior_log_prob,
                n_atoms=n_atoms, optimizer=optimizer, epochs=epochs,
                batchsize=batchsize, generator=generator, verbose=False,
            )
            ess = None
        else:
            log_p = np.asarray(prior_log_prob(theta_cat), np.float64)
            log_w = log_p - np.concatenate(all_logq)
            log_w -= log_w.max()
            w = np.exp(log_w).astype(np.float32)
            w /= w.mean()
            ess = float(w.sum() ** 2 / (w * w).sum())

            fit_posterior(
                flow, theta_cat, x_cat, weights=w if rnd > 0 else None,
                optimizer=optimizer, epochs=epochs, batchsize=batchsize,
                generator=generator, verbose=False,
            )
        history.append({"round": rnd + 1, "n_sims": int(len(theta_cat)),
                        "weight_ess": ess})
        if verbose:
            tag = "atomic" if method == "apt" else f"weight ESS {ess:.1f}"
            print(f"round {rnd + 1}: {len(theta_cat)} sims, {tag}, "
                  f"loss {flow.train_loss[-1]:.4f}")
    return flow, history


# -- SNPE-C / APT (atomic posterior transformation) ---------------------------


def apt_loss(model, base, theta_b, x_b, log_prior_b, atom_idx):
    """Atomic SNPE-C loss (Greenberg et al. 2019): for each example i with
    atom set A(i) (its own θ first),

        −log softmax over m ∈ A(i) of [ log q(θ_m | x_i) − log p(θ_m) ]
        evaluated at m = i.

    The −log p(θ_m) term makes the optimum the true posterior whatever pool
    the atoms come from, so multi-round fits need no importance weights.
    ``atom_idx`` (B, M) rows index into the batch; column 0 must be
    ``arange(B)``.
    """
    b, m = atom_idx.shape
    theta_atoms = theta_b[atom_idx].reshape(b * m, theta_b.shape[-1])
    x_rep = x_b.repeat_interleave(m, dim=0)
    z, ldj = model.inverse(theta_atoms, x_rep)
    lq = (base.log_prob(z) + ldj).reshape(b, m) - log_prior_b[atom_idx]
    return -(lq[:, 0] - torch.logsumexp(lq, dim=1)).mean()


def _atom_indices(generator, b, n_atoms, device="cpu"):
    """(B, M) atom index rows: column 0 = self, columns 1..M−1 drawn
    WITHOUT replacement from the other B−1 examples of the batch (the first
    M−1 of a random order of them, by sorting uniform keys)."""
    gen_device = generator.device if generator is not None else device
    keys = torch.rand((b, b - 1), generator=generator, device=gen_device)
    others = keys.argsort(dim=1)[:, : n_atoms - 1]
    self_idx = torch.arange(b, device=gen_device)[:, None]
    others = torch.where(others >= self_idx, others + 1, others)
    return torch.cat([self_idx, others], dim=1).to(device)


def fit_posterior_apt(
    flow: Flow,
    theta_samples,
    x_observations,
    prior_log_prob: Callable[[np.ndarray], np.ndarray] | None = None,
    *,
    n_atoms: int = 10,
    optimizer=None,
    epochs: int = 100,
    batchsize: int = 64,
    generator=None,
    verbose: bool = False,
    _draws=None,
):
    """Fit the flow as an amortized posterior q(θ | x) with the atomic
    SNPE-C / APT objective: θ drawn from ANY proposal trains correctly, as
    the atom-pool density cancels in the atomic softmax.

    ``prior_log_prob(θ) -> (n,)`` evaluates the PRIOR density at the raw θ
    rows; ``None`` means a uniform / improper-flat prior. Each epoch draws a
    permutation, cuts it into ``n // batchsize`` full batches (the ragged
    tail is dropped: atoms come from a full batch), and each batch draws its
    atoms; the per-epoch mean atomic loss is appended to
    ``flow.train_loss``. The steps run on the flow's device under autograd,
    through ``model.inverse`` (per-layer). Returns the optimizer state.
    """
    if optimizer is None:
        optimizer = Adam()
    theta_samples = np.asarray(theta_samples, np.float32)
    x_observations = np.asarray(x_observations, np.float32)
    n = theta_samples.shape[0]
    if x_observations.shape[0] != n:
        raise ValueError("theta and x must have the same number of rows")
    if not 2 <= n_atoms <= batchsize:
        raise ValueError(f"need 2 <= n_atoms <= batchsize, got {n_atoms}")
    n_batches = n // batchsize
    if n_batches == 0:
        raise ValueError(
            f"need at least one full batch ({batchsize}) of simulations, "
            f"got {n}"
        )

    # the posterior flow's DATA axis is θ and its CONDITION is x — so the
    # boundary normalization applies to x, through the flow's metadata (the
    # contract train() applies through DataArrays in fit_posterior)
    if flow.metadata.n:
        x_n = np.asarray(normalize_input(
            x_observations,
            np.asarray(flow.metadata.theta_min),
            np.asarray(flow.metadata.theta_max),
        ), np.float32)
    else:
        x_n = x_observations

    if prior_log_prob is None:
        log_p = np.zeros((n,), np.float32)
    else:
        log_p = np.asarray(prior_log_prob(theta_samples),
                           np.float32).reshape(n)
        if not np.isfinite(log_p).all():
            raise ValueError(
                "prior_log_prob must be finite at every simulated θ "
                "(out-of-support rows cannot train the atomic loss)"
            )

    dev = flow.device
    draws = _draws if _draws is not None else _Draws(generator, dev)
    th = torch.as_tensor(theta_samples).to(dev)
    x_t = torch.as_tensor(np.ascontiguousarray(x_n)).to(dev)
    lp_t = torch.as_tensor(log_p).to(dev)
    model, base = flow.model, flow.base
    opt_state = optimizer.init(trainable_leaves(model))
    epoch_losses = []
    for _ in range(epochs):
        perm = draws.permutation(n)
        idx = perm[: n_batches * batchsize].reshape(n_batches, batchsize)
        losses = []
        for bi in idx:
            atom_idx = draws.atoms(batchsize, n_atoms)
            opt_state, loss = _adam_step(
                model, optimizer, opt_state,
                lambda: apt_loss(model, base, th[bi], x_t[bi], lp_t[bi],
                                 atom_idx))
            losses.append(loss)
        epoch_losses.append(torch.stack(losses).mean())
    losses = torch.stack(epoch_losses).cpu().numpy()
    flow.train_loss.extend(float(v) for v in losses)
    if verbose:
        print(f"APT: {epochs} epochs, final atomic loss {losses[-1]:.4f}")
    return opt_state


# -- variational (reverse-KL) fit -------------------------------------------


def fit_variational(
    flow: Flow,
    log_density: Callable[[torch.Tensor], torch.Tensor],
    *,
    theta=None,
    optimizer=None,
    steps: int = 1000,
    n_particles: int = 1024,
    generator=None,
    mesh=None,
    verbose: bool = False,
    _draws=None,
):
    """Variational fit: minimize KL(q_flow ‖ p) for unnormalized log p.

    loss = E_{z~base}[ log q(x) − log p̃(x) ], x = flow.forward(z),
    log q(x) = base.log_prob(z) − ldj_forward — the reparameterized
    reverse-KL objective, one Adam step on a fresh base draw per step,
    through ``model.forward`` under autograd (per-layer, as in JAX; under
    ``set_fused_kernels(True)`` its couplings take the per-layer kernels).

    Appends the per-step losses to ``flow.train_loss``; returns the
    optimizer state.

    ``mesh``: the particles are split over the ``data`` axis; each rank's
    loss is its particles' sum over the GLOBAL count, and the loss and the
    gradients are summed over the axis (one all-reduce a step) before every
    rank applies the same update.
    """
    check_mesh(mesh)
    if optimizer is None:
        optimizer = Adam()
    rows = _share(mesh, n_particles)
    theta_n = flow.prepare_theta(theta, (n_particles,))[rows]
    model, base = flow.model, flow.base
    draws = _draws if _draws is not None else _Draws(generator, flow.device)

    def vi_loss(z):
        x, ldj = model.forward(z, theta_n)
        log_q = base.log_prob(z) - ldj
        if mesh is None:
            return (log_q - log_density(x)).mean()
        return (log_q - log_density(x)).sum() / n_particles

    opt_state = optimizer.init(trainable_leaves(model))
    losses = []
    for _ in range(steps):
        z = draws.base(base, (n_particles,))[rows]
        opt_state, loss = _adam_step(model, optimizer, opt_state,
                                     lambda: vi_loss(z), mesh)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    flow.train_loss.extend(float(v) for v in losses)
    if verbose and steps:
        print(f"VI: {steps} steps, final loss {losses[-1]:.4f}")
    return opt_state


# -- SMC ---------------------------------------------------------------------


def effective_sample_size(log_weights):
    """ESS = (Σw)²/Σw² from log-weights, numerically stable."""
    lw = log_weights - log_weights.max()
    w = torch.exp(lw)
    return w.sum().square() / (w * w).sum()


# the row length of _cumsum's fixed-order scan
_SCAN_ROW = 1024


def _cumsum(w):
    """Inclusive cumulative sum of a 1-D tensor with a fixed association,
    so two calls give the same bits on every device (``torch.cumsum`` of a
    1-D CUDA tensor runs a single-pass scan whose look-back adds the
    earlier tiles' sums in an order that varies between calls): rows of
    ``_SCAN_ROW`` entries are scanned along the row (an order that does not
    vary), and the rows' totals, scanned the same way, are added to the
    rows after them."""
    n = w.shape[0]
    if n <= _SCAN_ROW:
        # two rows: a scan of one row is a 1-D scan again
        return torch.cumsum(torch.stack([w, w]), dim=1)[0]
    rows = -(-n // _SCAN_ROW)
    padded = torch.nn.functional.pad(w, (0, rows * _SCAN_ROW - n))
    c = torch.cumsum(padded.reshape(rows, _SCAN_ROW), dim=1)
    totals = _cumsum(c[:, -1])
    offsets = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (c + offsets[:, None]).reshape(-1)[:n]


def _nan_last(cdf):
    """A CDF whose NaN entries (a NaN or all −inf log-weights) search as
    +inf: JAX's ``searchsorted`` orders NaN above every number, so every
    grid point then takes ancestor 0, as there."""
    return torch.where(torch.isnan(cdf), torch.full_like(cdf, float("inf")),
                       cdf)


def _systematic_resample(log_weights, u0):
    """Ancestor indices of systematic resampling for the stratified offset
    ``u0`` ∈ [0, 1): the grid (u0 + i)/n searched, from the left, in the
    normalized weights' CDF, clipped to [0, n−1]. The CDF is the cumulative
    sum (:func:`_cumsum`) of exp(lw − max lw) divided by its last entry (the arithmetic
    ``parallel.resample.systematic_resample_sharded`` does on one rank, so
    the two give the same rows there); JAX normalizes by the logsumexp
    first, so the two packages' CDFs can differ by a few ulp. A NaN CDF
    entry searches as +inf (:func:`_nan_last`)."""
    lw = log_weights.to(torch.float32)
    n = lw.shape[0]
    c = _cumsum(torch.exp(lw - lw.max()))
    cdf = _nan_last(c / c[-1])
    grid = (u0 + torch.arange(n, dtype=torch.float32, device=lw.device)) / n
    return torch.searchsorted(cdf, grid, side="left").clamp(0, n - 1)


def systematic_resample(log_weights, generator=None):
    """Systematic resampling: ancestor indices, shape like the weights, from
    one stratified offset u0 ~ U[0, 1) drawn from ``generator``."""
    u0 = _Draws(generator, log_weights.device).uniform(())
    return _systematic_resample(log_weights, u0)


@dataclasses.dataclass(frozen=True)
class SMCState:
    """Particles + log-weights + cached log-densities at the particles."""

    particles: torch.Tensor  # (n, d)
    log_weights: torch.Tensor  # (n,)
    log_prior: torch.Tensor  # (n,) cached log q0 (the init density)
    log_target: torch.Tensor  # (n,) cached log p̃ (unnormalized target)


def smc_step(
    state: SMCState,
    log_density: Callable[[torch.Tensor], torch.Tensor],
    log_prior: Callable[[torch.Tensor], torch.Tensor],
    lam_old,
    lam_new,
    generator=None,
    *,
    ess_threshold: float = 0.5,
    mh_step_size: float = 0.1,
    n_mh: int = 1,
    _draws=None,
    _mesh=None,
):
    """One tempered-SMC step on the ladder π_λ ∝ q0^(1−λ)·p̃^λ.

    Reweight by ``(p̃/q0)^Δλ``, resample systematically when the ESS falls
    below ``ess_threshold·n``, then ``n_mh`` random-walk Metropolis moves
    targeting π_{λ_new}. The resampling offset is drawn on every step,
    resampled or not, so the stream of draws does not depend on the test.
    Returns ``(state, ess, mean acceptance)``.

    ``_mesh`` (``run_smc(mesh=...)``): ``state`` holds this rank's equal
    block of the particles; ESS and the acceptance are over all of them
    (all-reduces), resampling is the ring resampler.
    """
    mesh = _mesh
    n_local = state.particles.shape[0]
    n = n_local * (1 if mesh is None else mesh.size)
    rows = _share(mesh, n)
    draws = _draws if _draws is not None else _Draws(
        generator, state.particles.device)
    dlam = lam_new - lam_old
    log_w = state.log_weights + dlam * (state.log_target - state.log_prior)
    if mesh is None:
        ess = effective_sample_size(log_w)
    else:
        top = mesh.all_reduce_(log_w.max().reshape(1),
                               op=torch.distributed.ReduceOp.MAX)
        w = torch.exp(log_w - top)
        sums = mesh.all_reduce_(torch.stack([w.sum(), (w * w).sum()]))
        ess = sums[0].square() / sums[1]
    u0 = draws.uniform(())
    particles, log_q0, log_tgt = (state.particles, state.log_prior,
                                  state.log_target)
    if bool(ess < ess_threshold * n):
        if mesh is None:
            idx = _systematic_resample(log_w, u0)
            particles, log_q0, log_tgt = (particles[idx], log_q0[idx],
                                          log_tgt[idx])
        else:
            from .parallel.resample import systematic_resample_sharded

            # the cached densities travel with their particles
            moved = systematic_resample_sharded(
                log_w, torch.cat([particles, log_q0[:, None],
                                  log_tgt[:, None]], 1), None, mesh, u0=u0)
            particles, log_q0, log_tgt = (moved[:, :-2], moved[:, -2],
                                          moved[:, -1])
        log_w = torch.zeros((n_local,), dtype=torch.float32,
                            device=log_w.device)

    # MH moves targeting π_{λ_new} ∝ q0^(1−λ)·p̃^λ
    accs = []
    for _ in range(n_mh):
        step = draws.normal((n,) + tuple(particles.shape[1:]))[rows]
        prop = particles + mh_step_size * step
        lq_prop = log_prior(prop)
        lp_prop = log_density(prop)
        log_alpha = ((1.0 - lam_new) * (lq_prop - log_q0)
                     + lam_new * (lp_prop - log_tgt))
        accept = torch.log(draws.uniform((n,))[rows]) < log_alpha
        particles = torch.where(accept[..., None], prop, particles)
        log_q0 = torch.where(accept, lq_prop, log_q0)
        log_tgt = torch.where(accept, lp_prop, log_tgt)
        accs.append(accept.to(torch.float32).mean() if mesh is None else
                    mesh.all_reduce_(accept.to(torch.float32).sum()) / n)
    acc = (torch.stack(accs).mean() if accs
           else torch.full((), float("nan"), device=particles.device))
    return SMCState(particles, log_w, log_q0, log_tgt), ess, acc


def run_smc(
    log_density: Callable[[torch.Tensor], torch.Tensor],
    d: int,
    n_particles: int = 4096,
    *,
    n_steps: int = 20,
    init_scale: float = 1.0,
    generator=None,
    ess_threshold: float = 0.5,
    mh_step_size: float = 0.1,
    n_mh: int = 2,
    mesh=None,
    device=None,
    _draws=None,
):
    """Tempered SMC from q0 = N(0, init_scale²·I) to exp(log_density),
    annealing π_λ ∝ q0^(1−λ)·p̃^λ over a linear λ-ladder of ``n_steps``
    :func:`smc_step` calls, on ``device`` (None: ``"cuda"``).

    Returns (particles, log_weights, {"ess": (n_steps,), "mh_accept":
    (n_steps,)}).

    ``mesh``: the particles are split in equal blocks over the ``data``
    axis (``n_particles`` must be a multiple of its size); every rank
    returns all of them.
    """
    check_mesh(mesh)
    device = resolve_device(device)
    if mesh is not None and n_particles % mesh.size:
        raise ValueError(
            f"run_smc(mesh=...) splits the particles in equal blocks: "
            f"n_particles {n_particles} is not a multiple of the data axis "
            f"({mesh.size})")
    rows = _share(mesh, n_particles)
    n_local = rows.stop - rows.start
    draws = _draws if _draws is not None else _Draws(generator, device)
    x0 = init_scale * draws.normal((n_particles, d))[rows]

    def log_prior(x):
        return -0.5 * (x * x).sum(-1) / (init_scale**2)

    lams = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32,
                          device=device)
    with torch.no_grad():
        state = SMCState(
            x0, torch.zeros((n_local,), dtype=torch.float32, device=device),
            log_prior(x0), log_density(x0),
        )
        ess_hist, acc_hist = [], []
        for i in range(n_steps):
            state, ess, acc = smc_step(
                state, log_density, log_prior, lams[i], lams[i + 1],
                ess_threshold=ess_threshold, mh_step_size=mh_step_size,
                n_mh=n_mh, _draws=draws, _mesh=mesh,
            )
            ess_hist.append(ess)
            acc_hist.append(acc.to(device))
    empty = torch.zeros((0,), device=device)
    return (_whole(mesh, state.particles, n_particles),
            _whole(mesh, state.log_weights, n_particles), {
                "ess": torch.stack(ess_hist) if ess_hist else empty,
                "mh_accept": torch.stack(acc_hist) if acc_hist else empty,
            })


# -- flow-accelerated MCMC --------------------------------------------------


def flow_mcmc(
    flow: Flow,
    log_density: Callable[[torch.Tensor], torch.Tensor],
    *,
    theta=None,
    n_chains: int = 256,
    n_steps: int = 1000,
    burn_in: int = 100,
    method: str = "independence",
    step_size: float = 0.2,
    generator=None,
    mesh=None,
    _draws=None,
):
    """MCMC targeting exp(log_density) with the trained flow as transport,
    over ``n_chains`` vectorized chains:

    - ``method='independence'``: independence Metropolis-Hastings —
      proposals are fresh flow samples, accepted with
      min(1, p(x')q(x)/(p(x)q(x'))); the acceptance rate measures the fit.
    - ``method='neutra'``: NeuTra preconditioning (Hoffman et al. 2019) —
      random-walk MH in the flow's latent space on the pulled-back target
      log p(f(z)) + ldj_f(z).

    Each step folds the chains through the flow with its ldj by
    ``models/flow.py::_chain_eval`` (the route ``Flow.forward`` takes): on
    a CUDA device a fusable chain is one ``chain_apply`` launch a step,
    where JAX folds ``model.forward`` layer by layer. The proposals' base
    draws come from ``generator`` (``torch.randn``, never ``chain_sample``).

    Returns ``(samples, diagnostics)``: samples of shape ``(n_steps −
    burn_in, n_chains, d)`` on the flow's device; diagnostics hold the
    per-step mean acceptance (``accept_rate``, ``(n_steps,)``),
    ``burn_in`` and, when at least 4 steps are kept, ``r_hat`` / ``ess``
    from :func:`mcmc_diagnostics`.

    ``mesh``: the chains are split over the ``data`` axis, each rank
    folding its chains; the acceptance counts are summed over the axis (one
    all-reduce at the end), and the kept draws gathered, so the diagnostics
    are over all chains on every rank.
    """
    if method not in ("independence", "neutra"):
        raise ValueError("method must be 'independence' or 'neutra'")
    if not 0 <= burn_in < n_steps:
        raise ValueError(f"need 0 <= burn_in < n_steps, got {burn_in}/{n_steps}")
    check_mesh(mesh)
    rows = _share(mesh, n_chains)
    n_local = rows.stop - rows.start
    theta_n = flow.prepare_theta(theta, (n_chains,))[rows]
    model, base = flow.model, flow.base
    draws = _draws if _draws is not None else _Draws(generator, flow.device)

    def fold(z):
        return _chain_eval(model, z, theta_n, "fwd")

    kept = torch.empty((n_steps - burn_in, n_local, flow.metadata.d),
                       device=flow.device)
    acc = torch.empty((n_steps,), device=flow.device)
    with torch.no_grad():
        z = draws.base(base, (n_chains,))[rows]
        x, ldj = fold(z)
        if method == "independence":
            # state: x, log p̃(x), log q(x)
            lp, lq = log_density(x), base.log_prob(z) - ldj
        else:
            lp = log_density(x) + ldj
        for t in range(n_steps):
            if method == "independence":
                z_p = draws.base(base, (n_chains,))[rows]
                x_p, ldj_p = fold(z_p)
                lp_p = log_density(x_p)
                lq_p = base.log_prob(z_p) - ldj_p
                log_alpha = (lp_p - lq_p) - (lp - lq)
                accept = torch.log(draws.uniform((n_chains,))[rows]) \
                    < log_alpha
                lq = torch.where(accept, lq_p, lq)
            else:  # neutra: RW on the pulled-back target in latent space
                z_p = z + step_size * draws.normal(
                    (n_chains, flow.metadata.d))[rows]
                x_p, ldj_p = fold(z_p)
                lp_p = log_density(x_p) + ldj_p
                accept = torch.log(draws.uniform((n_chains,))[rows]) \
                    < lp_p - lp
                z = torch.where(accept[..., None], z_p, z)
            x = torch.where(accept[..., None], x_p, x)
            lp = torch.where(accept, lp_p, lp)
            acc[t] = (accept.to(torch.float32).mean() if mesh is None
                      else accept.to(torch.float32).sum())
            if t >= burn_in:
                kept[t - burn_in] = x
    if mesh is not None:
        acc = mesh.all_reduce_(acc) / n_chains
        kept = mesh.all_gather_rows(kept.transpose(0, 1).contiguous(),
                                    n_chains).transpose(0, 1)
    diag = {"accept_rate": acc, "burn_in": burn_in}
    if kept.shape[0] >= 4:  # split-R̂/ESS need a few kept steps
        diag.update(mcmc_diagnostics(kept.cpu().numpy()))
    return kept, diag


def mcmc_diagnostics(samples):
    """Split-R̂ and effective sample size from ``(steps, chains, d)`` draws.

    The standard convergence checks (Gelman et al., BDA3 §11.4–11.5;
    Vehtari et al. 2021 split-chain form — the estimators Stan reports):

    - ``r_hat``: (d,) split-chain potential-scale-reduction. Each chain is
      split in half; R̂ ≈ 1.00 for mixed chains, > 1.01 flags
      non-convergence.
    - ``ess``: (d,) combined effective sample size across all chains, from
      FFT autocovariances averaged over chains with Geyer
      initial-positive-sequence truncation.

    Host-side numpy on the samples (a tensor is copied to the host).
    """
    s = np.asarray(_host(samples), np.float64)
    if s.ndim != 3:
        raise ValueError(f"need (steps, chains, d) samples, got {s.shape}")
    n, m, d = s.shape
    if n < 4:
        raise ValueError(f"need >= 4 post-burn-in steps for split-R̂, got {n}")
    half = n // 2
    sp = np.concatenate([s[:half], s[n - half:]], axis=1)  # (half, 2m, d)
    cn, cm = sp.shape[0], sp.shape[1]
    means = sp.mean(axis=0)                                # (2m, d)
    vars_ = sp.var(axis=0, ddof=1)
    w = vars_.mean(axis=0)                                 # within-chain
    b = cn * means.var(axis=0, ddof=1)                     # between-chain
    var_plus = (cn - 1) / cn * w + b / cn
    with np.errstate(divide="ignore", invalid="ignore"):
        r_hat = np.where(w > 0, np.sqrt(var_plus / w), np.inf)
        # constant-everywhere dims are trivially converged
        r_hat = np.where((w == 0) & (b == 0), 1.0, r_hat)

    # combined-chain autocovariance via FFT (biased 1/cn normalization)
    centered = sp - means[None]
    nfft = 1 << int(2 * cn - 1).bit_length()
    f = np.fft.rfft(centered, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:cn].real / cn
    mean_acov = acov.mean(axis=1)                          # (cn, d)
    safe_vp = np.where(var_plus > 0, var_plus, 1.0)
    rho = 1.0 - (w[None] - mean_acov) / safe_vp            # (cn, d)

    ess = np.empty(d)
    for j in range(d):
        if var_plus[j] == 0:
            ess[j] = cm * cn
            continue
        tau, t = 1.0, 1
        while t + 1 < cn:
            pair = rho[t, j] + rho[t + 1, j]
            if pair <= 0:
                break
            tau += 2.0 * pair
            t += 2
        ess[j] = cm * cn / max(tau, 1e-12)
    return {"r_hat": r_hat, "ess": ess}


# -- simulation-based calibration (SBC) -------------------------------------


def sbc_ranks(
    flow: Flow,
    theta_true,
    x_obs,
    *,
    n_draws: int = 256,
    generator=None,
):
    """Simulation-based-calibration ranks for an amortized posterior flow.

    For each simulation i (θᵢ ~ prior, xᵢ ~ sim(θᵢ)), draws ``n_draws``
    posterior samples from q(θ | xᵢ) — one ``flow.sample`` over all
    simulations at once, one ``chain_sample`` launch on a CUDA device with
    the standard-normal base — and ranks the TRUE θᵢ among them per
    parameter. A calibrated posterior gives ranks uniform on {0, …,
    n_draws} (Talts et al. 2018). Returns an (n_sims, d) int64 tensor.
    """
    theta_true = as_float32(theta_true, flow.device, "theta_true")
    x_obs = as_float32(x_obs, flow.device, "x_obs")
    n_sims = x_obs.shape[0]
    cond = x_obs.expand((n_draws,) + tuple(x_obs.shape))
    draws = flow.sample((n_draws, n_sims), cond, generator=generator)
    return (draws < theta_true[None]).sum(0)


def sbc_uniformity(ranks, n_draws: int):
    """Max-over-params Kolmogorov–Smirnov distance of the SBC ranks from
    uniform — 0 is perfectly calibrated; > ~1.6/√n_sims flags
    miscalibration at the 1% level."""
    ranks = np.asarray(_host(ranks), np.float64)
    n_sims, d = ranks.shape
    u = (ranks + 0.5) / (n_draws + 1)
    grid = np.sort(u, axis=0)
    emp = np.arange(1, n_sims + 1)[:, None] / n_sims
    return float(np.max(np.abs(grid - emp)))
