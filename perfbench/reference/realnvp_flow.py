"""Plain float32 reference of a conditional RealNVP chain (kind
``realnvp_flow``).

Written from the published equations (Dinh et al., "Density estimation using
Real NVP", 2017; the DensityFlows.jl CouplingLayer and NormalizationLayer),
in plain PyTorch, with no kernel, cache or batching of its own. It imports
nothing of the program under test: it takes the configuration, the weights
the benchmark drew and the raw data, and works out everything else (the
normalized conditions, the normalization layer's bounds) itself.

Conventions, as the configuration states them:

- a coupling transforms the dims listed in its ``transform`` (in that order:
  the conditioner's output column j acts on ``transform[j]``) and leaves the
  others (in increasing order) unchanged;
- each conditioner (``s`` and ``t``) is a ReLU MLP of ``concat(θ_norm,
  x_identity)``: ``n_sublayers`` hidden layers of width ``hidden``, then a
  linear layer; weights are stored (in, out);
- data → latent: ``z_af = (x_af − t)·exp(−s)``, ldj ``−Σ s``; latent → data:
  ``x_af = z_af·exp(s) + t``;
- the chain is the couplings in order, then one normalization layer that maps
  ``[x_min, x_max]`` onto ``[α, β]`` from data to latent;
- θ is min-max normalized over the prior box once, at the boundary;
- the base is the standard normal.
"""

from __future__ import annotations

import math

import torch

__all__ = ["param_layout", "coupling_axes", "Reference"]

_LOG_2PI = math.log(2.0 * math.pi)


def coupling_axes(cfg) -> list[tuple[list[int], list[int]]]:
    """``(identity dims, transformed dims)`` of every coupling, in order."""
    d = cfg["d"]
    out = []
    for c in cfg["couplings"]:
        af = [int(i) for i in c["transform"]]
        out.append(([i for i in range(d) if i not in af], af))
    return out


def param_layout(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """Every trainable tensor of the chain: ``(name, shape, role)`` with role
    ``hidden`` / ``final`` (a weight) or ``bias``. The order is the order of
    the flat weight vector the benchmark draws."""
    n, h, k = cfg["n_cond"], cfg["hidden"], cfg["n_sublayers"]
    out = []
    for ci, (ident, af) in enumerate(coupling_axes(cfg)):
        dims = [n + len(ident)] + [h] * k + [len(af)]
        for net in ("s", "t"):
            for li, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                role = "final" if li == len(dims) - 2 else "hidden"
                out.append((f"c{ci}.{net}.w{li}", (a, b), role))
                out.append((f"c{ci}.{net}.b{li}", (b,), "bias"))
    return out


class Reference:
    """The chain of ``cfg`` with the weights ``params`` (name → tensor, see
    :func:`param_layout`), the normalization layer built from ``norm_x``
    (rows of data) and the prior box ``theta_lo`` / ``theta_hi``."""

    def __init__(self, cfg, params: dict, norm_x, theta_lo, theta_hi):
        self.cfg = cfg
        self.p = params
        self.axes = coupling_axes(cfg)
        self.n_layers = cfg["n_sublayers"] + 1
        norm = cfg["normalization"]
        self.alpha, self.beta = float(norm["alpha"]), float(norm["beta"])
        flat = norm_x.reshape(-1, norm_x.shape[-1])
        self.x_lo = flat.min(0).values
        self.x_hi = flat.max(0).values
        self.theta_lo = theta_lo
        self.theta_hi = theta_hi
        self.d = cfg["d"]

    # -- pieces ---------------------------------------------------------------
    def normalize_theta(self, theta):
        diff = self.theta_hi - self.theta_lo
        safe = torch.where(diff == 0, torch.ones_like(diff), diff)
        y = (theta - self.theta_lo) / safe
        return torch.where(diff == 0, torch.zeros_like(y), y)

    def _net(self, ci, net, h):
        for li in range(self.n_layers):
            h = h @ self.p[f"c{ci}.{net}.w{li}"] + self.p[f"c{ci}.{net}.b{li}"]
            if li < self.n_layers - 1:
                h = torch.relu(h)
        return h

    def _st(self, ci, x, th_n):
        ident, _ = self.axes[ci]
        h = torch.cat([th_n, x[:, ident]], dim=-1)
        return self._net(ci, "s", h), self._net(ci, "t", h)

    def _norm_const(self):
        return torch.log((self.x_hi - self.x_lo)
                         / (self.beta - self.alpha)).sum()

    # -- maps -----------------------------------------------------------------
    def inverse(self, x, th_n):
        """data → latent, with the log-det-Jacobian per row."""
        lo, hi = self.x_lo, self.x_hi
        y = (self.beta * (x - lo) + self.alpha * (hi - x)) / (hi - lo)
        ldj = (-self._norm_const()).expand(x.shape[0])
        for ci in reversed(range(len(self.axes))):
            _, af = self.axes[ci]
            s, t = self._st(ci, y, th_n)
            y = y.clone()
            y[:, af] = (y[:, af] - t) * torch.exp(-s)
            ldj = ldj - s.sum(-1)
        return y, ldj

    def forward_(self, z, th_n):
        """latent → data, without the log-det-Jacobian (the sampling map)."""
        y = z
        for ci in range(len(self.axes)):
            _, af = self.axes[ci]
            s, t = self._st(ci, y, th_n)
            y = y.clone()
            y[:, af] = y[:, af] * torch.exp(s) + t
        lo, hi = self.x_lo, self.x_hi
        return ((hi - lo) * y - self.alpha * hi + self.beta * lo) \
            / (self.beta - self.alpha)

    def log_prob_normalized(self, x, th_n):
        z, ldj = self.inverse(x, th_n)
        return -0.5 * (self.d * _LOG_2PI + (z * z).sum(-1)) + ldj

    def log_prob(self, x, theta):
        """log p(x | θ) with θ raw (normalized here)."""
        return self.log_prob_normalized(x, self.normalize_theta(theta))

    def nll(self, x, theta):
        """Mean negative log-likelihood of the rows."""
        return -self.log_prob(x, theta).mean()

    def sample(self, z, theta):
        """The data rows of the base draw ``z`` under θ raw (one per row)."""
        return self.forward_(z, self.normalize_theta(theta))
