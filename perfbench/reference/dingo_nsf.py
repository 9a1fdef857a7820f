"""Plain float32 reference of Dingo's neural spline flow (kind ``dingo_nsf``).

Written from the published equations: Dax et al., "Real-time gravitational
wave science with neural posterior estimation", PRL 127, 241103 (2021),
whose flow (``dingo/core/nn/nsf.py``) nflows builds: Durkan et al., "Neural
Spline Flows" (2019), ``PiecewiseRationalQuadraticCouplingTransform`` with
linear tails, ``ResidualNet`` conditioners, ``LULinear`` mixing. Plain
PyTorch, no kernel, cache or batching of its own; it imports nothing of the
program under test.

Data → noise (the direction ``log_prob`` takes), for steps i = 0 … S−1:

1. ``y ← y[:, p_i]`` (the configuration's ``permutations[i]``), then
   ``y ← L_i U_i y + b_i``: L unit lower-triangular, U upper-triangular with
   diagonal ``softplus(ũ + c) + lu_eps``, ``c = log(e^(1 − lu_eps) − 1)``;
   ldj ``Σ log diag U``;
2. an RQ coupling: the dims ``i % 2, i % 2 + 2, …`` are transformed, the
   others (in increasing order) are the identity dims ``y_id``. The
   conditioner is nflows' ``ResidualNet``: ``h = W_in [y_id ; c] + b_in``;
   per block ``t = W_b ELU(BN_b(W_a ELU(BN_a(h)) + b_a)) + b_b`` and
   ``h ← h + t ⊙ sigmoid(W_c c + b_c)``; ``p = W_out h + b_out`` of size
   (dims, 3K − 1), column ``j·(3K − 1) + k`` of the output for dim j;
   widths ``p[:K] / √hidden``, heights ``p[K:2K] / √hidden``, inner
   derivatives ``p[2K:]``. The spline runs its closed form (data → noise)
   on ``[−B, B]``, identity outside, boundary derivatives
   ``min_derivative + softplus(log(e^(1 − min_derivative) − 1))`` (= 1),
   minimum bin width, height and derivative 1e-3; knots pinned at ±B.

Then ``y ← y[:, p_S]``, ``L_S U_S y + b_S``. ``log p(x | c) = log N(z; 0,
I) + Σ ldj``. Sampling runs the inverse maps in the reverse order (the
spline's root, the triangular solves).

Batch norm (eps, momentum from the configuration; ``nn.BatchNorm1d``'s
arithmetic, ``F.batch_norm``): :meth:`Reference.nll` is train mode — each BN
normalises by the batch's mean and biased variance and moves its running
mean and variance (unbiased) by ``momentum``; both start at 0 and 1. :meth:`Reference.log_prob` and :meth:`Reference.sample`
are eval mode: the running statistics.

Departures from nflows / Dingo, as the configuration's ``assumed`` states
them: the context ``c`` is the raw context min-max normalised over the
prior box (Dingo's is its embedding network's output); every weight comes
from the benchmark's seeded draw (``param_layout`` roles), not nflows'
initialisation; the LU diagonals' ũ is stored less nflows' identity value
``c`` (nflows' parameter is ũ + c: the same map and gradients), so that the
draw puts diag U near 1, as nflows' identity initialisation does; no
dropout (Dingo's 0.0); no embedding network.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["param_layout", "step_axes", "Reference"]

_LOG_2PI = math.log(2.0 * math.pi)


def step_axes(cfg, i: int) -> tuple[list[int], list[int]]:
    """``(identity dims, transformed dims)`` of step ``i``'s coupling:
    nflows' alternating mask, the even dims transformed at even steps."""
    d = int(cfg["d"])
    af = list(range(i % 2, d, 2))
    return [k for k in range(d) if k not in af], af


def _n_spline(cfg) -> int:
    return 3 * int(cfg["num_bins"]) - 1


def param_layout(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """Every trainable tensor: ``(name, shape, role)``, weights stored
    (in, out); 1-D leaves (biases, batch norm's γ and β, the LU entries and
    diagonals) take the role ``bias``. The order of the flat weight vector
    the benchmark draws."""
    d, n, h = int(cfg["d"]), int(cfg["n_cond"]), int(cfg["hidden_dim"])
    m = d * (d - 1) // 2
    out = []

    def lu(i):
        out.extend([(f"lu{i}.lower", (m,), "bias"),
                    (f"lu{i}.upper", (m,), "bias"),
                    (f"lu{i}.diag", (d,), "bias"),
                    (f"lu{i}.bias", (d,), "bias")])

    steps = int(cfg["num_flow_steps"])
    for i in range(steps):
        lu(i)
        ident, af = step_axes(cfg, i)
        c = f"c{i}"
        out += [(f"{c}.w_in", (len(ident) + n, h), "hidden"),
                (f"{c}.b_in", (h,), "bias")]
        for j in range(int(cfg["num_transform_blocks"])):
            blk = f"{c}.blk{j}"
            for a, bn in (("a", "bn0"), ("b", "bn1")):
                if cfg["batch_norm"]:
                    out += [(f"{blk}.{bn}.weight", (h,), "bias"),
                            (f"{blk}.{bn}.bias", (h,), "bias")]
                out += [(f"{blk}.w_{a}", (h, h), "hidden"),
                        (f"{blk}.b_{a}", (h,), "bias")]
            out += [(f"{blk}.w_c", (n, h), "hidden"),
                    (f"{blk}.b_c", (h,), "bias")]
        out += [(f"{c}.w_out", (h, len(af) * _n_spline(cfg)), "final"),
                (f"{c}.b_out", (len(af) * _n_spline(cfg),), "bias")]
    lu(steps)
    return out


class Reference:
    """The flow of ``cfg`` with the weights ``params`` (name → tensor, see
    :func:`param_layout`) and the prior box ``theta_lo`` / ``theta_hi``
    (``norm_x`` is not read: this flow has no normalization layer)."""

    def __init__(self, cfg, params: dict, norm_x, theta_lo, theta_hi):
        del norm_x
        self.cfg, self.p = cfg, params
        self.d = int(cfg["d"])
        self.steps = int(cfg["num_flow_steps"])
        self.blocks = int(cfg["num_transform_blocks"])
        self.hidden = int(cfg["hidden_dim"])
        self.k = int(cfg["num_bins"])
        self.bound = float(cfg["tail_bound"])
        self.bn = bool(cfg["batch_norm"])
        self.bn_eps = float(cfg["batch_norm_eps"])
        self.momentum = float(cfg["batch_norm_momentum"])
        self.lu_eps = float(cfg["lu_eps"])
        self.lu_shift = math.log(math.expm1(1.0 - self.lu_eps))
        self.min_w = float(cfg["min_bin_width"])
        self.min_h = float(cfg["min_bin_height"])
        self.min_d = float(cfg["min_derivative"])
        self.perms = [list(map(int, p)) for p in cfg["permutations"]]
        if len(self.perms) != self.steps + 1:
            raise ValueError("permutations must hold num_flow_steps + 1 lists")
        self.theta_lo, self.theta_hi = theta_lo, theta_hi
        dev = theta_lo.device
        self.running = {}
        if self.bn:
            for i in range(self.steps):
                for j in range(self.blocks):
                    for bn in ("bn0", "bn1"):
                        self.running[f"c{i}.blk{j}.{bn}"] = (
                            torch.zeros(self.hidden, device=dev),
                            torch.ones(self.hidden, device=dev))
        tri = torch.tril_indices(self.d, self.d, -1, device=dev)
        self._lower_idx = (tri[0], tri[1])
        tri = torch.triu_indices(self.d, self.d, 1, device=dev)
        self._upper_idx = (tri[0], tri[1])

    # -- pieces ---------------------------------------------------------------
    def normalize_theta(self, theta):
        diff = self.theta_hi - self.theta_lo
        safe = torch.where(diff == 0, torch.ones_like(diff), diff)
        y = (theta - self.theta_lo) / safe
        return torch.where(diff == 0, torch.zeros_like(y), y)

    def _lu(self, i):
        p, d = self.p, self.d
        lower = torch.zeros(d, d, device=p[f"lu{i}.lower"].device)
        lower[self._lower_idx] = p[f"lu{i}.lower"]
        lower = lower + torch.eye(d, device=lower.device)
        diag = F.softplus(p[f"lu{i}.diag"] + self.lu_shift) + self.lu_eps
        upper = torch.zeros(d, d, device=lower.device)
        upper[self._upper_idx] = p[f"lu{i}.upper"]
        upper = upper + torch.diag(diag)
        return lower, upper, torch.log(diag).sum()

    def _lu_fwd(self, i, y):
        lower, upper, ldj = self._lu(i)
        return (y @ upper.T) @ lower.T + self.p[f"lu{i}.bias"], ldj

    def _lu_inv(self, i, y):
        lower, upper, _ = self._lu(i)
        v = (y - self.p[f"lu{i}.bias"]).T
        v = torch.linalg.solve_triangular(lower, v, upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(upper, v, upper=True).T

    def _batch_norm(self, name, t, train):
        """``nn.BatchNorm1d``'s arithmetic, as nflows' blocks hold it."""
        mean, var = self.running[name]
        return F.batch_norm(t, mean, var, self.p[name + ".weight"],
                            self.p[name + ".bias"], train, self.momentum,
                            self.bn_eps)

    def _conditioner(self, i, y_id, c, train):
        p, c_ = self.p, f"c{i}"
        h = torch.cat([y_id, c], dim=-1) @ p[f"{c_}.w_in"] + p[f"{c_}.b_in"]
        for j in range(self.blocks):
            blk = f"{c_}.blk{j}"
            t = h
            for a, bn in (("a", "bn0"), ("b", "bn1")):
                if self.bn:
                    t = self._batch_norm(f"{blk}.{bn}", t, train)
                t = F.elu(t) @ p[f"{blk}.w_{a}"] + p[f"{blk}.b_{a}"]
            gate = torch.sigmoid(c @ p[f"{blk}.w_c"] + p[f"{blk}.b_c"])
            h = h + t * gate
        return h @ p[f"{c_}.w_out"] + p[f"{c_}.b_out"]

    def _knots(self, raw, lo, hi, minimum):
        """Cumulative knots on [lo, hi] (ends pinned) and bin sizes."""
        k = raw.shape[-1]
        frac = minimum + (1.0 - minimum * k) * torch.softmax(raw, dim=-1)
        cum = torch.cumsum(frac, dim=-1)
        cum = (hi - lo) * cum[..., :-1] + lo
        edge = torch.full_like(cum[..., :1], lo)
        cum = torch.cat([edge, cum, torch.full_like(edge, hi)], dim=-1)
        return cum, cum[..., 1:] - cum[..., :-1]

    def _spline(self, x, raw, inverse):
        """nflows' unconstrained RQ spline with linear tails on [−B, B]:
        ``(outputs, per-element logabsdet)``."""
        k, b = self.k, self.bound
        sq = math.sqrt(self.hidden)
        uw, uh = raw[..., :k] / sq, raw[..., k:2 * k] / sq
        const = math.log(math.expm1(1.0 - self.min_d))
        ud = F.pad(raw[..., 2 * k:], (1, 1), value=const)
        inside = (x >= -b) & (x <= b)
        xc = torch.clamp(x, -b, b)
        cw, widths = self._knots(uw, -b, b, self.min_w)
        ch, heights = self._knots(uh, -b, b, self.min_h)
        deriv = self.min_d + F.softplus(ud)
        locs = (ch if inverse else cw).detach().clone()
        locs[..., -1] += 1e-6
        idx = (torch.sum(xc[..., None] >= locs, dim=-1) - 1)[..., None]

        def at(a):
            return a.gather(-1, idx)[..., 0]

        x0, w, y0, hh = at(cw), at(widths), at(ch), at(heights)
        delta = hh / w
        d0, d1 = at(deriv[..., :-1]), at(deriv[..., 1:])
        if not inverse:
            theta = (xc - x0) / w
            tt = theta * (1 - theta)
            numer = hh * (delta * theta ** 2 + d0 * tt)
            denom = delta + (d0 + d1 - 2 * delta) * tt
            out = y0 + numer / denom
        else:
            dy = xc - y0
            a = dy * (d0 + d1 - 2 * delta) + hh * (delta - d0)
            bq = hh * d0 - dy * (d0 + d1 - 2 * delta)
            cq = -delta * dy
            disc = torch.clamp(bq ** 2 - 4 * a * cq, min=0.0)
            theta = (2 * cq) / (-bq - torch.sqrt(disc))
            tt = theta * (1 - theta)
            denom = delta + (d0 + d1 - 2 * delta) * tt
            out = theta * w + x0
        dnum = delta ** 2 * (d1 * theta ** 2 + 2 * delta * tt
                             + d0 * (1 - theta) ** 2)
        lad = torch.log(dnum) - 2 * torch.log(denom)
        if inverse:
            lad = -lad
        return (torch.where(inside, out, x),
                torch.where(inside, lad, torch.zeros_like(lad)))

    def _coupling(self, i, y, c, train, inverse):
        ident, af = step_axes(self.cfg, i)
        raw = self._conditioner(i, y[:, ident], c, train)
        raw = raw.reshape(y.shape[0], len(af), 3 * self.k - 1)
        out, lad = self._spline(y[:, af], raw, inverse)
        cols = [None] * self.d
        for j, k in enumerate(ident):
            cols[k] = y[:, k]
        for j, k in enumerate(af):
            cols[k] = out[:, j]
        return torch.stack(cols, dim=-1), lad.sum(-1)

    # -- maps -----------------------------------------------------------------
    def to_noise(self, x, c, train=False):
        """data → noise with the log-det-Jacobian per row."""
        y, ldj = x, torch.zeros(x.shape[0], device=x.device)
        for i in range(self.steps):
            y, l = self._lu_fwd(i, y[:, self.perms[i]])
            ldj = ldj + l
            y, lc = self._coupling(i, y, c, train, False)
            ldj = ldj + lc
        y, l = self._lu_fwd(self.steps, y[:, self.perms[self.steps]])
        return y, ldj + l

    def to_data(self, z, c):
        """noise → data (eval mode), the inverse of :meth:`to_noise`."""
        y = z
        for i in range(self.steps, -1, -1):
            if i < self.steps:
                y, _ = self._coupling(i, y, c, False, True)
            y = self._lu_inv(i, y)
            inv = [0] * self.d
            for j, k in enumerate(self.perms[i]):
                inv[k] = j
            y = y[:, inv]
        return y

    def _log_prob(self, x, theta, train):
        z, ldj = self.to_noise(x, self.normalize_theta(theta), train)
        return -0.5 * (self.d * _LOG_2PI + (z * z).sum(-1)) + ldj

    def log_prob(self, x, theta):
        """log p(x | θ), θ raw, batch norm in eval mode."""
        return self._log_prob(x, theta, False)

    def nll(self, x, theta):
        """Mean negative log-likelihood in train mode (running statistics
        moved)."""
        return -self._log_prob(x, theta, True).mean()

    def sample(self, z, theta):
        """The data rows of the base draw ``z`` under θ raw (eval mode)."""
        return self.to_data(z, self.normalize_theta(theta))
