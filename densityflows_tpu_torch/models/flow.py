"""The Flow engine: model + base distribution + θ-metadata + histories.

PyTorch counterpart of ``densityflows_tpu/models/flow.py``:

- θ is min-max normalized to [0,1] exactly once, at the Flow boundary, using
  metadata captured from the data;
- every API has an unconditional form — ``theta=None`` plays the role of the
  zero-width sentinel (valid only for n = 0 flows);
- ``sample`` = base draw → ldj-free forward sweep; on a CUDA device a
  fusable chain with the standard-normal base draws inside the
  ``chain_sample`` kernel, and with any other base draws from the base and
  runs the sweep on ``chain_apply``;
- ``log_prob`` = base.log_prob(inverse(x)) + ldj, with the grid variant over
  per-axis vectors;
- loss = −mean(base.log_prob(z) + ldj);
- train/valid loss histories live on the Flow.

The Flow lives on one device, given at construction (``device=None`` means
``"cuda"``). Inputs may be numpy arrays or tensors and must be float32.
Randomness comes from an explicit ``torch.Generator``.

``mesh=`` (a ``parallel.mesh.Mesh``) on ``sample`` / ``sample_sweep`` /
``log_prob`` splits the row axis over the mesh's ``data`` axis: every rank
works on its :func:`~..parallel.mesh.host_local_rows` share (one
``chain_apply`` / ``chain_sample`` launch per rank for a fusable chain on
CUDA) and returns the WHOLE result, gathered in one all-gather, as the JAX
package returns a global array. Every rank passes the same inputs and an
equally seeded generator. The draws equal the one-process draw of the same
generator state: ``chain_sample`` counts its in-kernel generator by the
global row (``row_offset``); the plain path and the CPU draw the whole base
sample on every rank and fold their rows of it.

While a ``torch.profiler`` session records, ``log_prob`` (array form),
``sample`` and ``sample_sweep`` record their stages (``df.theta``,
``df.plan``, ``df.enqueue``, ``df.density``) as spans of
``utils/spans.py``.

Not ported: the row-chunked folds of the JAX package (ROADMAP A.6).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .._device import as_float32, resolve_device
from ..data import DataArrays, MetaData, normalize_input
from ..parallel.mesh import Mesh, check_mesh, host_local_rows
from ..utils.spans import span, unrecorded
from .chains import FlowChain
from .distributions import StandardNormal

__all__ = ["Flow", "nll_loss"]


def nll_loss(model, base, x, theta):
    """Forward-KL NLL: −mean(base.log_prob(z) + ldj) over the batch."""
    z, ldj = model.inverse(x, theta)
    return -(base.log_prob(z) + ldj).mean()


def _chain_eval(model, y, theta, dirn, staged=False):
    """Inverse/forward fold with ldj, routed through the whole-chain kernel
    where the policy says so (models/fused_chain.py; grad-safe). ``staged``
    (one entry-point call, no loop): the routing and the plan lookup in a
    ``df.plan`` span (``hit``: the folded parameters reused), the launch, or
    the per-layer path, in a ``df.enqueue`` span."""
    stage = span if staged else unrecorded
    found = None
    with stage("df.plan") as s:
        if isinstance(model, FlowChain) and y.dim() >= 2:
            from .fused_chain import fused_plan

            n = theta.shape[-1] if theta is not None else 0
            found = fused_plan(model, y.shape[-1], n, dirn, y.device)
            if found is not None and s.recording:
                s.counts["hit"] = found[1]
    with stage("df.enqueue"):
        if found is not None:
            from .fused_chain import apply_fused

            return apply_fused(model, y, theta, dirn, True, found[0])
        return (model.forward(y, theta) if dirn == "fwd"
                else model.inverse(y, theta))


class Flow:
    """Flow = model chain + base distribution + θ-metadata + loss histories."""

    def __init__(
        self,
        model: FlowChain,
        data_or_metadata,
        base=None,
        train_loss: list | None = None,
        valid_loss: list | None = None,
        *,
        device=None,
    ):
        if isinstance(data_or_metadata, DataArrays):
            metadata = data_or_metadata.metadata()
        elif isinstance(data_or_metadata, MetaData):
            metadata = data_or_metadata
        else:
            raise TypeError("pass a DataArrays or a MetaData")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.metadata = metadata
        base = base if base is not None else StandardNormal(metadata.d)
        # a parameterized base (its tensors are buffers) joins the flow's
        # device; it is not part of the model, so training leaves it fixed
        self.base = base.to(self.device) if isinstance(base, nn.Module) \
            else base
        self.train_loss: list[float] = list(train_loss or [])
        self.valid_loss: list[float] = list(valid_loss or [])
        # per-epoch counts of batch updates skipped as non-finite
        # (populated by train(skip_nonfinite=True))
        self.skipped_updates: list[int] = []
        # which path the most recent train() call ran ("fused" = the
        # whole-run train kernel, "torch" = the plain program) and, when the
        # kernel declined, the envelope/surface item that blocked it
        self.trained_path: str | None = None
        self.fused_decline_reason: str | None = None
        # which mode the last train_fused run used ("resident")
        self.fused_kernel_mode: str | None = None
        # device-resident θ bounds for boundary normalization
        self._theta_min = torch.as_tensor(
            np.asarray(metadata.theta_min, np.float32)).to(self.device)
        self._theta_max = torch.as_tensor(
            np.asarray(metadata.theta_max, np.float32)).to(self.device)

    # -- θ boundary handling --------------------------------------------------
    def prepare_theta(self, theta, batch_shape):
        """Broadcast θ to (batch..., n) and min-max normalize it to [0,1].

        Accepts ``None`` (unconditional: zero-width sentinel), a scalar/tuple
        of n values (one θ for every sample), or an array of shape
        (batch..., n).

        Shape rule (deterministic — no batch-size-dependent flips): any
        scalar / tuple / list / 0-D / 1-D input is ALWAYS one θ-vector of
        the flow's n conditions, broadcast to every sample; per-sample
        conditions must be explicitly shaped (batch..., n). A 1-D array
        whose length isn't n raises (e.g. per-sample scalars for an n=1
        flow must be passed as (batch, 1), not (batch,)).
        """
        n = self.metadata.n
        batch_shape = tuple(batch_shape)
        if theta is None:
            if n:
                raise ValueError(
                    f"this flow is conditional (n={n}); pass theta "
                    "(the unconditional theta=None form is only valid for "
                    "n=0 flows)"
                )
            return torch.zeros(batch_shape + (0,), device=self.device)
        if isinstance(theta, (int, float)):
            theta = (theta,)
        if isinstance(theta, torch.Tensor):
            theta = theta.to(self.device, torch.float32)
        else:
            theta = torch.as_tensor(
                np.asarray(theta, np.float32)).to(self.device)
        if theta.dim() <= 1:
            vec = theta.reshape(-1)
            if vec.shape[0] != n:
                raise ValueError(
                    f"theta must have {n} entries, got {vec.shape[0]} "
                    f"(1-D theta is always one condition vector broadcast "
                    f"to the batch; per-sample conditions need shape "
                    f"{batch_shape + (n,)})"
                )
            theta = vec.expand(batch_shape + (n,))
        elif tuple(theta.shape) != batch_shape + (n,):
            raise ValueError(
                f"theta shape {tuple(theta.shape)} must be "
                f"{batch_shape + (n,)}"
            )
        if n == 0:
            return theta
        return normalize_input(theta, self._theta_min, self._theta_max)

    # -- transforms -------------------------------------------------------
    def forward(self, z, theta=None):
        """latent → data with ldj, θ normalized at the boundary."""
        z = as_float32(z, self.device, "z")
        return _chain_eval(self.model, z,
                           self.prepare_theta(theta, z.shape[:-1]), "fwd")

    def inverse(self, x, theta=None):
        """data → latent with ldj."""
        x = as_float32(x, self.device, "x")
        return _chain_eval(self.model, x,
                           self.prepare_theta(theta, x.shape[:-1]), "inv")

    backward = inverse

    def predict(self, z, theta=None):
        """Transformed sample without ldj."""
        return self.forward(z, theta)[0]

    # -- sampling ---------------------------------------------------------
    def _fused_sampler_applies(self) -> bool:
        return (isinstance(self.base, StandardNormal)
                and isinstance(self.model, FlowChain))

    def sample(self, dims, theta=None, *, generator=None, mesh=None):
        """Draw samples of shape (*dims, d).

        ``theta``: None, a tuple of n scalars (shared by all draws), or an
        array of shape (*dims, n). ``generator``: a ``torch.Generator``
        (None: a fresh non-deterministic one). ``mesh``: split the draws
        over the mesh's ``data`` axis (module docstring); every rank gets
        all of them.
        """
        check_mesh(mesh)
        if isinstance(dims, int):
            dims = (dims,)
        dims = tuple(int(s) for s in dims)
        rows = int(np.prod(dims)) if dims else 1
        with span("df.sample"):
            with span("df.theta"):
                # a scalar/tuple θ stays one row: the kernel broadcasts it
                if theta is None or isinstance(theta,
                                               (int, float, tuple, list)):
                    theta_n = self.prepare_theta(theta, (1,))
                else:
                    theta_n = self.prepare_theta(theta, dims).reshape(
                        rows, self.metadata.n)
            return self._sample_rows(dims, theta_n, generator,
                                     mesh).reshape(dims + (self.metadata.d,))

    def sample_sweep(self, thetas, n_per_theta: int, *, generator=None,
                     mesh=None):
        """Conditional sampling sweep over a grid of θ values.

        ``thetas``: (G, n) array (or list of tuples) of conditions. Returns
        draws of shape (G, n_per_theta, d) from one pass over the flattened
        (G·n_per_theta) draw axis, split over ``mesh``'s ``data`` axis when
        given.
        """
        check_mesh(mesh)
        n, d = self.metadata.n, self.metadata.d
        with span("df.sample_sweep"):
            with span("df.theta"):
                if isinstance(thetas, torch.Tensor):
                    thetas = thetas.to(self.device, torch.float32)
                else:
                    thetas = torch.as_tensor(
                        np.asarray(thetas, np.float32)).to(self.device)
                if thetas.dim() != 2 or thetas.shape[-1] != n:
                    raise ValueError(f"thetas must have shape (G, {n})")
                g = thetas.shape[0]
                total = g * n_per_theta
                theta_full = thetas.repeat_interleave(n_per_theta, dim=0)
                theta_n = normalize_input(theta_full, self._theta_min,
                                          self._theta_max) if n \
                    else theta_full
            return self._sample_rows((total,), theta_n, generator,
                                     mesh).reshape(g, n_per_theta, d)

    def _sample_rows(self, dims, theta_n, generator, mesh):
        """The draw of ``dims`` flattened to ``(rows, d)``. ``theta_n``: the
        normalized θ, (1, n) broadcast or (rows, n). Each rank of ``mesh``
        (None: this process alone) folds its :func:`host_local_rows` share
        and the shares are gathered over the ``data`` axis."""
        mesh = mesh if mesh is not None else Mesh()
        d, n = self.metadata.d, self.metadata.n
        rows = int(np.prod(dims)) if dims else 1
        sl = host_local_rows(mesh, rows)
        lo, hi = sl.start, sl.stop
        th = theta_n if theta_n.shape[0] == 1 else theta_n[lo:hi]
        found = None
        with span("df.plan") as s:
            if self._fused_sampler_applies():
                from .fused_chain import fused_plan

                found = fused_plan(self.model, d, n, "fwd")
                if found is not None and s.recording:
                    s.counts["hit"] = found[1]
        with span("df.enqueue"):
            if found is not None:
                from .fused_chain import sample_fused

                out = sample_fused(found[0], generator, hi - lo, d, th,
                                   row_offset=lo, total_rows=rows)
            else:
                # every rank draws the whole base sample from its equally
                # seeded generator (the one-process stream) and folds its
                # rows
                r = self.base.sample(generator, dims, self.device)
                r = r.reshape(rows, d)[lo:hi]
                out = self.model.forward_(r, th.expand(hi - lo, n))
        return mesh.all_gather_rows(out, rows)

    # -- densities --------------------------------------------------------
    def log_prob(self, x, theta=None, *, grid_chunk: int = 65536, mesh=None):
        """log pdf at x.

        ``x`` may also be a tuple of d per-axis vectors — then the log-pdf
        is evaluated on the full tensor-product grid and returned with
        shape (len(x[0]), ..., len(x[d-1])); in that form a conditional flow
        requires θ as a tuple of n scalars. Grids larger than ``grid_chunk``
        rows are evaluated in chunks of that many rows (peak memory
        O(grid_chunk·d) + output).

        ``mesh`` (array form only): split the rows over the mesh's ``data``
        axis; each rank evaluates its share (one ``chain_apply`` launch for
        a fusable chain on CUDA) and every rank returns all of them.
        """
        if isinstance(x, (tuple, list)) and all(np.ndim(v) == 1 for v in x):
            if mesh is not None:
                raise ValueError("mesh sharding applies to the array form "
                                 "of log_prob, not the grid form")
            return self._log_prob_grid(tuple(x), theta, grid_chunk)
        with span("df.log_prob"):
            check_mesh(mesh)
            mesh = mesh if mesh is not None else Mesh()
            with span("df.theta"):
                x = as_float32(x, self.device, "x")
                theta_n = self.prepare_theta(theta, x.shape[:-1])
                batch_shape = x.shape[:-1]
                rows = int(np.prod(batch_shape)) if batch_shape else 1
                sl = host_local_rows(mesh, rows)
                x_rows = x.reshape(rows, x.shape[-1])[sl]
                theta_rows = theta_n.reshape(rows, theta_n.shape[-1])[sl]
            z, ldj = _chain_eval(self.model, x_rows, theta_rows, "inv",
                                 staged=True)
            with span("df.density"):
                lp = mesh.all_gather_rows(self.base.log_prob(z) + ldj, rows)
                return lp.reshape(batch_shape)

    def _log_prob_grid(self, axes_vectors: tuple, theta, grid_chunk: int):
        d = self.metadata.d
        if len(axes_vectors) != d:
            raise ValueError(f"grid must have {d} axis vectors")
        vecs = [torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                if not isinstance(v, torch.Tensor)
                else v.to(self.device, torch.float32) for v in axes_vectors]
        lens = [int(v.shape[0]) for v in vecs]
        total = int(np.prod(lens))
        theta_row = self.prepare_theta(theta, (1,))
        chunk = int(min(grid_chunk, total))
        parts = []
        for start in range(0, total, chunk):
            # grid points from mixed-radix indices ('ij': last axis fastest)
            rem = torch.arange(start, min(start + chunk, total),
                               device=self.device)
            coords = []
            for v in reversed(vecs):
                coords.append(v[rem % v.shape[0]])
                rem = rem // v.shape[0]
            pts = torch.stack(coords[::-1], dim=-1)
            th = theta_row.expand(pts.shape[0], theta_row.shape[-1])
            z, ldj = _chain_eval(self.model, pts, th, "inv")
            parts.append(self.base.log_prob(z) + ldj)
        return torch.cat(parts).reshape(lens)

    def prob(self, x, theta=None):
        """pdf = exp(log_prob)."""
        return torch.exp(self.log_prob(x, theta))

    logpdf = log_prob
    pdf = prob

    # -- histories --------------------------------------------------------
    @property
    def training_loss(self) -> list[float]:
        return self.train_loss

    @property
    def validation_loss(self) -> list[float]:
        return self.valid_loss

    def summarize(self) -> str:
        return (
            "- model --------------------\n"
            + self.model.summarize()
            + "\n- base distribution --------\n"
            + type(self.base).__name__
        )
