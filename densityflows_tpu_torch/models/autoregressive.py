"""Masked autoregressive flow (MAF) layers and their dual (IAF).

PyTorch counterpart of ``densityflows_tpu/models/autoregressive.py``. A MAF
layer (Papamakarios et al. 2017) transforms EVERY dim with an affine map
whose parameters depend autoregressively on the preceding dims: one masked
pass in the density direction (``inverse``), a loop of d masked passes in
the sampling direction (``forward``). An IAF layer (Kingma et al. 2016) is
the dual: parameters autoregressive in the latent, so ``forward`` is one
pass and ``inverse`` the loop. Direction convention as in the package
(forward = latent → data):

    MAF inverse:  z_i = (x_i − μ_i(x_{<i}, θ)) · exp(−α_i),  ldj = −Σ α
    MAF forward:  x_i = z_i · exp(α_i(x_{<i}, θ)) + μ_i       (d passes)

α is clamped through tanh scaling (±``max_log_scale``).
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from ..ops.made import MaskedMLP, apply_made, init_made

__all__ = ["MAFLayer", "maf_layer", "IAFLayer", "iaf_layer"]


class _Autoregressive(nn.Module):
    def __init__(self, net: MaskedMLP, d: int, n: int = 0,
                 max_log_scale: float = 5.0):
        super().__init__()
        self.net = net
        self.d = int(d)
        self.n = int(n)
        self.max_log_scale = float(max_log_scale)

    def _mu_alpha(self, x, theta):
        out = apply_made(self.net, torch.cat([theta, x], -1))
        out = out.reshape(out.shape[:-1] + (self.d, 2))
        mu, alpha = out[..., 0], out[..., 1]
        m = self.max_log_scale
        return mu, m * torch.tanh(alpha / m)

    def _sequential(self, y, theta, step):
        """The d-pass direction: pass i sets dim i of the output from the
        parameters of the dims set before it; returns (out, Σ α_i)."""
        out = torch.zeros_like(y)
        col = torch.arange(self.d, device=y.device)
        alphas = []
        for i in range(self.d):
            mu, alpha = self._mu_alpha(out, theta)
            v = step(y[..., i], mu[..., i], alpha[..., i])
            out = torch.where(col == i, v[..., None], out)
            alphas.append(alpha[..., i])
        return out, torch.stack(alphas, -1).sum(-1)

    def summarize(self) -> str:
        return (f"{type(self).__name__:<17} | made  > {list(self.net.dims)} "
                f"(d={self.d}, n={self.n})")


class MAFLayer(_Autoregressive):
    """Affine masked autoregressive flow over all d dims."""

    def inverse(self, x, theta):
        """data → latent: one parallel masked pass (the training path)."""
        mu, alpha = self._mu_alpha(x, theta)
        return (x - mu) * torch.exp(-alpha), -alpha.sum(-1)

    def forward(self, z, theta):
        """latent → data: sequential over dims (x_i needs x_{<i})."""
        return self._sequential(
            z, theta, lambda zi, mu, a: zi * torch.exp(a) + mu)

    def forward_(self, z, theta):
        return self.forward(z, theta)[0]


class IAFLayer(_Autoregressive):
    """Inverse autoregressive flow: sampling is one pass, density
    evaluation the d-pass loop."""

    def forward(self, z, theta):
        mu, alpha = self._mu_alpha(z, theta)
        return z * torch.exp(alpha) + mu, alpha.sum(-1)

    def forward_(self, z, theta):
        return self.forward(z, theta)[0]

    def inverse(self, x, theta):
        z, sum_alpha = self._sequential(
            x, theta, lambda xi, mu, a: (xi - mu) * torch.exp(-a))
        return z, -sum_alpha


def _layer(cls, d, n, generator, n_sublayers, hidden_dim, activation,
           max_log_scale, device):
    net = init_made(generator, d, n, 2, n_sublayers, hidden_dim=hidden_dim,
                    activation=activation, device=resolve_device(device))
    return cls(net, d, n, float(max_log_scale))


def maf_layer(d: int, *, n: int = 0, generator=None, n_sublayers: int = 2,
              hidden_dim: int = 64, activation: str = "relu",
              max_log_scale: float = 5.0, device=None) -> MAFLayer:
    """Build a MAF layer (pair with :func:`permutation_layer` between
    stacked MAF layers to vary the autoregressive order)."""
    return _layer(MAFLayer, d, n, generator, n_sublayers, hidden_dim,
                  activation, max_log_scale, device)


def iaf_layer(d: int, *, n: int = 0, generator=None, n_sublayers: int = 2,
              hidden_dim: int = 64, activation: str = "relu",
              max_log_scale: float = 5.0, device=None) -> IAFLayer:
    """Build an IAF layer (sampling-fast dual of :func:`maf_layer`)."""
    return _layer(IAFLayer, d, n, generator, n_sublayers, hidden_dim,
                  activation, max_log_scale, device)
