"""Data pipeline: containers, partitioning, and min-max normalization.

Own copy of ``densityflows_tpu/data.py`` (the host-side pipeline is NumPy;
the JAX package cannot be imported from here). Semantics:

- ``dflt_theta``: zero-width conditions sentinel so every API has an
  unconditional form;
- ``MetaData``: (hash, d, n, θ_min, θ_max) captured from the data and used
  to normalize θ to [0,1] exactly once at the Flow boundary;
- ``DataPartition``: seeded random permutation split into
  train/valid/test index sets;
- ``DataArrays``: raw x and θ plus the partition;
- ``normalize_input`` / ``resize_output``: min-max map to [0,1] and back,
  zero-range conditions map to 0.

Arrays are row-major ``(batch..., d)`` / ``(batch..., n)``: features on the
last axis, partitioning along axis 0.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .utils.spans import span

__all__ = [
    "dflt_theta",
    "MetaData",
    "DataPartition",
    "DataArrays",
    "normalize_input",
    "resize_output",
    "minimum_theta",
    "maximum_theta",
    "number_dimensions",
    "number_conditions",
]

Array = np.ndarray  # host-side pipeline is NumPy; device code uses torch


def dflt_theta(x_or_shape, dtype=np.float32) -> Array:
    """Zero-width conditions sentinel.

    ``dflt_theta(x)`` returns an array with x's batch shape and a
    trailing condition axis of size 0, so ``concat([theta, ...], -1)`` is a
    no-op prepend. Reference ``dflt_θ`` with the first
    axis moved to the last.
    """
    if hasattr(x_or_shape, "shape"):
        batch_shape = tuple(x_or_shape.shape[:-1])
        dtype = x_or_shape.dtype
    else:
        batch_shape = tuple(int(s) for s in x_or_shape)
    return np.zeros(batch_shape + (0,), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class MetaData:
    """Identification hash + dims + condition bounds."""

    hash: str
    d: int
    n: int
    theta_min: Array
    theta_max: Array

    def __post_init__(self):
        object.__setattr__(
            self, "theta_min", np.asarray(self.theta_min).reshape(-1)
        )
        object.__setattr__(
            self, "theta_max", np.asarray(self.theta_max).reshape(-1)
        )
        if self.theta_min.shape != (self.n,) or self.theta_max.shape != (self.n,):
            raise ValueError(
                f"theta bounds must have shape ({self.n},); got "
                f"{self.theta_min.shape} / {self.theta_max.shape}"
            )


def minimum_theta(obj) -> Array:
    """Per-condition minimum."""
    if isinstance(obj, MetaData):
        return obj.theta_min
    return obj.minimum_theta


def maximum_theta(obj) -> Array:
    """Per-condition maximum."""
    if isinstance(obj, MetaData):
        return obj.theta_max
    return obj.maximum_theta


@dataclasses.dataclass(frozen=True)
class DataPartition:
    """Random train/valid/test index split.

    ``DataPartition.make(n)`` draws a seeded permutation and slices it at
    ``round(n * f_training)`` and ``+ round(n * f_validation)``; any
    remainder is the test set.
    """

    training: Array
    validation: Array
    testing: Array

    @classmethod
    def make(
        cls,
        n: int,
        f_training: float = 0.9,
        f_validation: float = 0.1,
        rng: np.random.Generator | int | None = None,
    ) -> "DataPartition":
        if rng is None or isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(rng)
        p = rng.permutation(n)
        i1 = round(n * f_training)
        i2 = i1 + round(n * f_validation)
        return cls(p[:i1], p[i1:i2], p[i2:n])


@dataclasses.dataclass(frozen=True)
class DataArrays:
    """Raw data + conditions + partition.

    ``x``: shape ``(batch..., d)``; ``theta``: shape ``(batch..., n)`` with
    matching batch dims. Partitioning is along axis 0 only — ensure axis 0
    is the large sample axis.
    """

    x: Array
    theta: Array
    partition: DataPartition

    @classmethod
    def make(
        cls,
        x,
        theta=None,
        *,
        f_training: float = 0.9,
        f_validation: float = 0.1,
        rng: np.random.Generator | int | None = None,
    ) -> "DataArrays":
        x = np.asarray(x)
        if theta is None:
            theta = dflt_theta(x)
        theta = np.asarray(theta)
        if x.ndim < 2:
            raise ValueError("x must have shape (batch..., d) — at least 2-D")
        if x.shape[:-1] != theta.shape[:-1]:
            raise ValueError(
                f"x and theta batch shapes must match: {x.shape[:-1]} vs "
                f"{theta.shape[:-1]}"
            )
        partition = DataPartition.make(x.shape[0], f_training, f_validation, rng)
        return cls(x, theta, partition)

    # -- accessors ------------------------
    @property
    def num_dimensions(self) -> int:
        return self.x.shape[-1]

    @property
    def num_conditions(self) -> int:
        return self.theta.shape[-1]

    @property
    def minimum_theta(self) -> Array:
        if self.num_conditions == 0 or self.theta.size == 0:
            return np.zeros((self.num_conditions,), self.theta.dtype)
        return self.theta.reshape(-1, self.num_conditions).min(axis=0)

    @property
    def maximum_theta(self) -> Array:
        if self.num_conditions == 0 or self.theta.size == 0:
            return np.zeros((self.num_conditions,), self.theta.dtype)
        return self.theta.reshape(-1, self.num_conditions).max(axis=0)

    def training_data(self) -> tuple[Array, Array]:
        idx = self.partition.training
        return self.x[idx], self.theta[idx]

    def validation_data(self) -> tuple[Array, Array]:
        idx = self.partition.validation
        return self.x[idx], self.theta[idx]

    def testing_data(self) -> tuple[Array, Array]:
        idx = self.partition.testing
        return self.x[idx], self.theta[idx]

    # -- normalized split getters ---------
    def normalized_training_data(self, metadata: MetaData) -> tuple[Array, Array]:
        x, th = self.training_data()
        return x, normalize_input(th, metadata.theta_min, metadata.theta_max)

    def normalized_validation_data(self, metadata: MetaData) -> tuple[Array, Array]:
        x, th = self.validation_data()
        return x, normalize_input(th, metadata.theta_min, metadata.theta_max)

    def normalized_splits_on(self, metadata: MetaData, device, weights=None):
        """``(x_train, th_train, x_valid, th_valid, w_train, w_valid)``: the
        splits of :meth:`normalized_training_data` /
        :meth:`normalized_validation_data` and the rows of ``weights`` (per
        raw row; None: ``w_train`` and ``w_valid`` are None) as float32
        tensors on ``device``, the same bits as the host getters followed by
        a float32 copy.

        Where the two splits hold at least half of the rows, their indices
        lie in ``[0, rows)`` and θ and its bounds are float32 or float64, it
        copies the raw rows, θ and the index arrays once and picks and
        normalizes the splits on ``device``, θ in the dtype NumPy would use;
        else (a large testing split, say) NumPy gathers them on the host.
        Spans: ``df.upload`` (``bytes``) around the copies, ``df.gather``
        (``dev``: 1 on ``device``, 0 on the host) around the gather."""
        n_rows = self.x.shape[0]
        w = None
        if weights is not None:
            w = np.asarray(weights, np.float32).reshape(-1)
            if w.shape[0] != n_rows:
                raise ValueError(
                    f"weights must have one entry per data row "
                    f"({n_rows}), got {w.shape[0]}")
        tr = np.asarray(self.partition.training)
        va = np.asarray(self.partition.validation)
        if _gathers_on_device(tr, va, n_rows, self.theta, metadata):
            return self._splits_on_device(metadata, device, w, tr, va)
        with span("df.gather", dev=0):
            x_t, th_t = self.normalized_training_data(metadata)
            x_v, th_v = self.normalized_validation_data(metadata)
            w_t, w_v = (None, None) if w is None else (w[tr], w[va])
        with span("df.upload") as up:
            out = tuple(None if a is None else _put(a, device)
                        for a in (x_t, th_t, x_v, th_v, w_t, w_v))
            if up.recording:
                up.counts["bytes"] = _nbytes(*out)
        return out

    def _splits_on_device(self, metadata, device, w, tr, va):
        """:meth:`normalized_splits_on` on ``device``: the raw arrays live
        until the return."""
        with span("df.upload") as up:
            x = _put(self.x, device)
            th = _as_tensor(np.ascontiguousarray(self.theta), device)
            t_min = _as_tensor(metadata.theta_min, device)
            t_max = _as_tensor(metadata.theta_max, device)
            idx = [_as_tensor(np.asarray(i, np.int64), device)
                   for i in (tr, va)]
            w = None if w is None else _as_tensor(w, device)
            if up.recording:
                up.counts["bytes"] = _nbytes(x, th, t_min, t_max, *idx, w)
        dtype = torch.promote_types(th.dtype, torch.promote_types(
            t_min.dtype, t_max.dtype))
        with span("df.gather", dev=1):
            xs, ths, ws = [], [], []
            for i in idx:
                xs.append(x.index_select(0, i))
                ths.append(normalize_input(
                    th.index_select(0, i).to(dtype), t_min, t_max)
                    .to(torch.float32))
                ws.append(None if w is None else w.index_select(0, i))
        return xs[0], ths[0], xs[1], ths[1], ws[0], ws[1]

    def metadata(self, hash: str = "") -> MetaData:
        """Capture a :class:`MetaData` from this data."""
        return MetaData(
            hash,
            self.num_dimensions,
            self.num_conditions,
            self.minimum_theta,
            self.maximum_theta,
        )

    def summarize(self) -> str:
        nb = self.x.shape[0]
        ft = len(self.partition.training) / nb if nb else 0.0
        fv = len(self.partition.validation) / nb if nb else 0.0
        return (
            f"Data with size {self.x.shape} and conditions with size "
            f"{self.theta.shape}.\n-> f_training = {ft}, f_validation = {fv}."
        )


def number_dimensions(data: DataArrays) -> int:
    """Reference ``number_dimensions``."""
    return data.num_dimensions


def number_conditions(data: DataArrays) -> int:
    """Reference ``number_conditions``."""
    return data.num_conditions


def normalize_input(x, x_min, x_max):
    """Min-max normalize the LAST axis to [0,1]; zero-range dims map to 0.

    Works on NumPy arrays and torch tensors alike (bounds of the same kind
    as ``x``).
    """
    if isinstance(x, np.ndarray):
        x_min = np.asarray(x_min)
        diff = x_max - x_min
        # avoid 0/0 → NaN, then force zero-range dims to exactly 0
        y = (x - x_min) / np.where(diff == 0, 1, diff)
        return np.where(diff == 0, np.zeros((), dtype=y.dtype), y)
    diff = x_max - x_min
    y = (x - x_min) / torch.where(diff == 0, torch.ones_like(diff), diff)
    return torch.where(diff == 0, torch.zeros_like(y), y)


def resize_output(y, x_min, x_max):
    """Inverse of :func:`normalize_input`."""
    return (x_max - x_min) * y + x_min


_DEVICE_FLOATS = (np.dtype(np.float32), np.dtype(np.float64))


def _gathers_on_device(tr, va, n_rows, theta, metadata) -> bool:
    """Whether :meth:`DataArrays.normalized_splits_on` gathers on the
    device: the splits hold at least half of the rows (so the raw copy is
    at most twice the splits' bytes), their integer indices lie in
    ``[0, n_rows)`` (an index out of range raises on the host, as NumPy's
    gather does), and θ and its bounds are float32 or float64 (whose
    arithmetic the device does bit for bit as NumPy does)."""
    if 2 * (tr.size + va.size) < n_rows:
        return False
    if any(a.dtype not in _DEVICE_FLOATS for a in
           (theta, metadata.theta_min, metadata.theta_max)):
        return False
    for i in (tr, va):
        if i.ndim != 1 or i.dtype.kind not in "iu":
            return False
        if i.size and (i.min() < 0 or i.max() >= n_rows):
            return False
    return True


def _as_tensor(a, device):
    """A host array as a tensor on ``device``, without a host copy where
    ``torch.as_tensor`` makes none. A read-only array is only read, so
    torch's warning about it is dropped."""
    if a.flags.writeable:
        return torch.as_tensor(a).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.as_tensor(a).to(device)


def _put(a, device):
    """A host array as a float32 tensor on ``device``."""
    return _as_tensor(np.ascontiguousarray(a, np.float32), device)


def _nbytes(*arrays) -> int:
    """Bytes of the arrays (or tensors) that are not None."""
    return sum(int(a.nbytes) for a in arrays if a is not None)
