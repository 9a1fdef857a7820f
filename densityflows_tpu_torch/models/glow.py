"""Glow-family layers: ActNorm and LU-parameterized invertible linear.

PyTorch counterpart of ``densityflows_tpu/models/glow.py``.

- :class:`ActNormLayer`: a trainable per-dim affine whose init is
  data-dependent (latents start whitened) but whose apply is
  batch-independent.
- :class:`InvertibleLinearLayer`: a dense, trainable feature mixing
  W = P L U with the log-determinant read off the U diagonal. The forward
  (sampling) direction uses two triangular solves.
- :class:`LULinearLayer`: nflows' ``LULinear`` (the mixing of Dingo's
  flows): ``y = L U x + b`` from data to latent, L unit lower-triangular,
  U upper-triangular with diagonal ``softplus(ũ + c) + 1e-3``, a trainable
  bias; no permutation (a ``PermutationLayer`` beside it gives one). ``c =
  log(e^(1 − 1e-3) − 1)`` is nflows' identity value of its ũ, so ũ = 0 is
  diag U = 1.

``forward`` = latent → data, ``inverse`` = data → latent, both returning
per-sample ldj of batch shape; ``forward_`` is the ldj-free sampling path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

__all__ = [
    "ActNormLayer", "actnorm_layer",
    "InvertibleLinearLayer", "invertible_linear_layer",
    "LULinearLayer", "lu_linear_layer",
]


class ActNormLayer(nn.Module):
    """Trainable per-dim affine: z = (x - bias) * exp(log_scale)."""

    def __init__(self, bias, log_scale):
        super().__init__()
        self.bias = nn.Parameter(bias)
        self.log_scale = nn.Parameter(log_scale)

    def _ldj(self, batch_shape):
        return self.log_scale.sum().expand(batch_shape)

    def inverse(self, x, theta=None):
        """data → latent: z = (x - b)·exp(s); ldj = +Σ log_scale."""
        z = (x - self.bias) * torch.exp(self.log_scale)
        return z, self._ldj(x.shape[:-1])

    def forward(self, z, theta=None):
        """latent → data: x = z·exp(−s) + b; ldj = −Σ log_scale."""
        return self.forward_(z), -self._ldj(z.shape[:-1])

    def forward_(self, z, theta=None):
        return z * torch.exp(-self.log_scale) + self.bias

    def summarize(self) -> str:
        return f"ActNorm Layer     | d = {self.bias.shape[0]} (trainable)"


def actnorm_layer(x, *, eps: float = 1e-6, device=None) -> ActNormLayer:
    """Data-dependent init: bias = per-dim mean, log_scale = −log(std), so
    the first inverse pass emits whitened latents. Accepts a data array
    ``(batch..., d)``, a :class:`~densityflows_tpu_torch.data.DataArrays`
    (uses its x), or an ``int d`` for identity init."""
    from ..data import DataArrays

    device = resolve_device(device)
    if isinstance(x, int):
        return ActNormLayer(torch.zeros(x, device=device),
                            torch.zeros(x, device=device))
    if isinstance(x, DataArrays):
        x = x.x
    x = np.asarray(x, np.float32).reshape(-1, np.shape(x)[-1])
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    return ActNormLayer(
        torch.as_tensor(mean).to(device),
        torch.as_tensor((-np.log(std + eps)).astype(np.float32)).to(device),
    )


class InvertibleLinearLayer(nn.Module):
    """Dense invertible feature mixing, W = P·L·U.

    ``P`` is a static permutation; ``L`` is unit-lower-triangular (the
    strict lower part of ``lower`` is trainable); ``U``'s strict upper part
    is trainable and its diagonal is ``sign · exp(log_s)`` with static
    signs, so log|det W| = Σ log_s without any determinant evaluation.
    """

    def __init__(self, lower, upper, log_s, perm, sign):
        super().__init__()
        self.lower = nn.Parameter(lower)
        self.upper = nn.Parameter(upper)
        self.log_s = nn.Parameter(log_s)
        self.perm = tuple(int(i) for i in perm)
        self.sign = tuple(float(s) for s in sign)

    @property
    def d(self) -> int:
        return len(self.perm)

    def _lu(self):
        eye = torch.eye(self.d, dtype=self.log_s.dtype,
                        device=self.log_s.device)
        l = torch.tril(self.lower, -1) + eye
        diag = torch.tensor(self.sign, dtype=self.log_s.dtype,
                            device=self.log_s.device) * torch.exp(self.log_s)
        u = torch.triu(self.upper, 1) + torch.diag(diag)
        return l, u

    def _w(self):
        l, u = self._lu()
        return (l @ u)[list(self.perm), :]  # rows permuted: W = P L U

    def _inv_perm(self):
        inv = np.empty(self.d, np.int64)
        inv[list(self.perm)] = np.arange(self.d)
        return inv.tolist()

    def _ldj(self, batch_shape):
        return self.log_s.sum().expand(batch_shape)

    def inverse(self, x, theta=None):
        """data → latent: z = x Wᵀ (one matmul); ldj = +Σ log_s."""
        return x @ self._w().T, self._ldj(x.shape[:-1])

    def _solve(self, z):
        """latent → data: solve W xᵀ = zᵀ via the LU factors (two
        triangular solves — no matrix inverse is formed)."""
        l, u = self._lu()
        batch_shape = z.shape[:-1]
        v = z.reshape(-1, self.d)[:, self._inv_perm()].T     # P⁻¹ zᵀ
        y = torch.linalg.solve_triangular(l, v, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(u, y, upper=True)
        return x.T.reshape(batch_shape + (self.d,))

    def forward(self, z, theta=None):
        return self._solve(z), -self._ldj(z.shape[:-1])

    def forward_(self, z, theta=None):
        return self._solve(z)

    def summarize(self) -> str:
        return f"InvertibleLinear  | d = {self.d} (P·L·U, trainable)"


def invertible_linear_layer(d: int, *, generator=None,
                            device=None) -> InvertibleLinearLayer:
    """Init as a random rotation (QR of a Gaussian), LU-factorized once on
    the host so training never touches a determinant or pivot."""
    import scipy.linalg

    device = resolve_device(device)
    g = torch.randn(d, d, generator=generator, dtype=torch.float64,
                    device=generator.device if generator is not None else "cpu")
    q, _ = np.linalg.qr(g.cpu().numpy())
    p, l, u = scipy.linalg.lu(q)
    # p @ l @ u = q with p a permutation matrix; perm[i] = row of (l@u) that
    # lands in row i of W, i.e. argmax over p's columns.
    perm = tuple(int(j) for j in np.argmax(p, axis=1))
    diag = np.diag(u).copy()
    sign = tuple(float(s) for s in np.sign(diag))
    log_s = np.log(np.abs(diag))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    return InvertibleLinearLayer(f32(np.tril(l, -1)), f32(np.triu(u, 1)),
                                 f32(log_s), perm, sign)


class LULinearLayer(nn.Module):
    """nflows' ``LULinear``: data → latent ``y = L U x + b``, ldj
    ``Σ log diag U``. ``lower`` / ``upper`` hold the strict triangles'
    entries in ``numpy.tril_indices(d, -1)`` / ``triu_indices(d, 1)`` order,
    ``unconstrained_diag`` ũ with ``diag U = softplus(ũ + c) + eps``, ``c =
    log(e^(1 − eps) − 1)`` (nflows stores ũ + c: the same map and
    gradients, with ũ = 0 at the identity), ``bias`` b. The forward
    (sampling) direction solves the two triangles."""

    def __init__(self, lower, upper, unconstrained_diag, bias, *,
                 eps: float = 1e-3):
        super().__init__()
        self.lower = nn.Parameter(lower)
        self.upper = nn.Parameter(upper)
        self.unconstrained_diag = nn.Parameter(unconstrained_diag)
        self.bias = nn.Parameter(bias)
        self.eps = float(eps)
        self.shift = math.log(math.expm1(1.0 - self.eps))

    @property
    def d(self) -> int:
        return int(self.bias.shape[0])

    def _diag(self):
        return F.softplus(self.unconstrained_diag + self.shift) + self.eps

    def _lu(self, diag):
        d, dev, dt = self.d, self.bias.device, self.bias.dtype
        lo = torch.tril_indices(d, d, -1, device=dev)
        up = torch.triu_indices(d, d, 1, device=dev)
        l = torch.eye(d, dtype=dt, device=dev).index_put(
            (lo[0], lo[1]), self.lower)
        u = torch.diag(diag).index_put((up[0], up[1]), self.upper)
        return l, u

    def weight(self):
        """W = L U (data → latent ``y = x Wᵀ + b``)."""
        l, u = self._lu(self._diag())
        return l @ u

    def inverse(self, x, theta=None):
        """data → latent: y = (x Uᵀ) Lᵀ + b, as nflows multiplies; ldj =
        +Σ log diag U."""
        diag = self._diag()
        l, u = self._lu(diag)
        ldj = torch.log(diag).sum().expand(x.shape[:-1])
        return (x @ u.T) @ l.T + self.bias, ldj

    def _solve(self, y):
        l, u = self._lu(self._diag())
        batch_shape = y.shape[:-1]
        v = (y.reshape(-1, self.d) - self.bias).T
        v = torch.linalg.solve_triangular(l, v, upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(u, v, upper=True)
        return x.T.reshape(batch_shape + (self.d,))

    def forward(self, z, theta=None):
        ldj = torch.log(self._diag()).sum().expand(z.shape[:-1])
        return self._solve(z), -ldj

    def forward_(self, z, theta=None):
        return self._solve(z)

    def summarize(self) -> str:
        return f"LULinear          | d = {self.d} (L·U + b, trainable)"


def lu_linear_layer(d: int, *, eps: float = 1e-3,
                    device=None) -> LULinearLayer:
    """nflows' identity initialisation: every leaf zero, diag U = 1."""
    device = resolve_device(device)
    m = d * (d - 1) // 2
    return LULinearLayer(torch.zeros(m, device=device),
                         torch.zeros(m, device=device),
                         torch.zeros(d, device=device),
                         torch.zeros(d, device=device), eps=eps)
