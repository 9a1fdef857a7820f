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

import numpy as np
import torch

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
