"""Coupling-axes: static masking metadata for coupling layers.

Own copy of ``densityflows_tpu/axes.py`` (pure Python; the JAX package
cannot be imported from here). Semantics:

- ``axis_id``: feature indices the layer leaves untouched (identity dims),
- ``axis_af``: feature indices receiving the affine transform,
- ``axis_nn``: indices into ``concat([theta, x], axis=-1)`` that feed the
  conditioner networks — the ``n`` conditions first, then the identity dims
  shifted by ``n`` (θ-first ordering, triangular-Jacobian structure).

Indices are 0-based. The axes object is a frozen, hashable dataclass held as
a plain (static) attribute of a layer module.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["CouplingAxes", "coupling_axes", "reverse_axes", "is_reverse"]


@dataclasses.dataclass(frozen=True)
class CouplingAxes:
    """Static description of which feature dims a coupling layer transforms.

    0-based index tuples. Equality is permutation-insensitive.
    """

    d: int
    n: int
    axis_id: tuple[int, ...]
    axis_af: tuple[int, ...]
    axis_nn: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_id) + len(self.axis_af) != self.d:
            raise ValueError(
                f"axis_id ({self.axis_id}) and axis_af ({self.axis_af}) must "
                f"partition range({self.d})"
            )
        if set(self.axis_id) | set(self.axis_af) != set(range(self.d)):
            raise ValueError("axis_id and axis_af must partition range(d)")

    # -- permutation-insensitive equality / hash
    def __eq__(self, other) -> bool:
        if not isinstance(other, CouplingAxes):
            return NotImplemented
        return (
            self.d == other.d
            and self.n == other.n
            and sorted(self.axis_id) == sorted(other.axis_id)
            and sorted(self.axis_af) == sorted(other.axis_af)
            and sorted(self.axis_nn) == sorted(other.axis_nn)
        )

    def __hash__(self) -> int:
        return hash(
            (
                self.d,
                self.n,
                tuple(sorted(self.axis_id)),
                tuple(sorted(self.axis_af)),
                tuple(sorted(self.axis_nn)),
            )
        )

    def reverse(self) -> "CouplingAxes":
        """Swap identity and transformed dims."""
        axis_nn = tuple(range(self.n)) + tuple(i + self.n for i in self.axis_af)
        return CouplingAxes(self.d, self.n, self.axis_af, self.axis_id, axis_nn)

    @property
    def nn_input_dim(self) -> int:
        """Width of the conditioner-network input (n conditions + identity dims)."""
        return len(self.axis_nn)

    @property
    def transform_dim(self) -> int:
        """Width of the conditioner-network output (transformed dims)."""
        return len(self.axis_af)

    def summarize(self) -> str:
        sid = ",".join(map(str, self.axis_id))
        saf = ",".join(map(str, self.axis_af))
        return f"(d,n)=({self.d},{self.n}); identity=({sid}), transformed=({saf})"


def coupling_axes(
    d: int,
    mask: Sequence[int] | int | None = None,
    *,
    n: int = 0,
    reverse: bool = False,
) -> CouplingAxes:
    """Build a :class:`CouplingAxes`.

    - ``coupling_axes(d, mask, n=...)`` — explicit list of transformed dims
      (0-based);
    - ``coupling_axes(d, j, n=..., reverse=...)`` — split point ``j``:
      identity on the first ``j`` dims (``reverse=False``) or on the last
      ``d-j`` dims (``reverse=True``);
    - ``coupling_axes(d)`` — default split at ``d // 2``.

    For the data-driven forms pass ``d=data.num_dimensions,
    n=data.num_conditions``, or use the ``coupling_layer(data, ...)``
    factories in ``models.layers``.
    """
    if mask is None:
        mask = d // 2
    if isinstance(mask, int):
        j = mask
        if not 0 <= j <= d:
            raise ValueError(f"split point j={j} out of range for d={d}")
        transformed = tuple(range(j, d)) if not reverse else tuple(range(j))
    else:
        transformed = tuple(int(i) for i in mask)
        if any(not 0 <= i < d for i in transformed):
            raise ValueError(
                f"mask {transformed} contains values outside range({d}) "
                "(indices are 0-based)"
            )
        if len(set(transformed)) != len(transformed):
            raise ValueError(f"mask {transformed} contains duplicates")

    axis_af = transformed
    axis_id = tuple(i for i in range(d) if i not in set(axis_af))
    axis_nn = tuple(range(n)) + tuple(i + n for i in axis_id)
    return CouplingAxes(d, n, axis_id, axis_af, axis_nn)


def reverse_axes(axes: CouplingAxes) -> CouplingAxes:
    """Functional form of :meth:`CouplingAxes.reverse`."""
    return axes.reverse()


def is_reverse(axes_1: CouplingAxes, axes_2: CouplingAxes) -> bool:
    """True iff the two axes are complementary."""
    return (
        axes_1.axis_af == axes_2.axis_id
        and axes_2.axis_af == axes_1.axis_id
        and axes_1.n == axes_2.n
    )
