"""Toy 2-D densities for density-matching sanity checks.

Counterpart of ``densityflows_tpu/utils/datasets.py``, this package's own
copy (numpy only), so its draws equal the JAX package's bit for bit for the
same ``rng``. BASELINE.json config 2 ("2-D toy densities (two-moons/rings),
unconditional 8-layer coupling stack — density-matching sanity check"): the
standard 2-D benchmark densities of the flow literature.

All generators return float32 ``(n, 2)`` arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["two_moons", "rings", "moons_manifold_distance",
           "rings_manifold_distance"]


def two_moons(n: int, *, noise: float = 0.1, rng=0) -> np.ndarray:
    """Two interleaved half-circles with isotropic Gaussian noise.

    Upper moon: unit half-circle centred at the origin (angles [0, π]);
    lower moon: half-circle centred at (1, 0.5), reflected (angles
    [π, 2π]) — the standard scikit-learn-style construction.
    """
    rng = np.random.default_rng(rng)
    n_up = n // 2
    n_lo = n - n_up
    a_up = rng.uniform(0.0, np.pi, n_up)
    a_lo = rng.uniform(0.0, np.pi, n_lo)
    up = np.stack([np.cos(a_up), np.sin(a_up)], axis=1)
    lo = np.stack([1.0 - np.cos(a_lo), 0.5 - np.sin(a_lo)], axis=1)
    x = np.concatenate([up, lo]).astype(np.float32)
    x += rng.normal(scale=noise, size=x.shape).astype(np.float32)
    return x[rng.permutation(n)]


def moons_manifold_distance(x: np.ndarray) -> np.ndarray:
    """Per-point distance to the nearest of the two (noise-free) moon
    arcs — small for points the two-moons density actually covers."""
    x = np.asarray(x, np.float64)
    # distance to a half-circle = distance to the full circle when the
    # angular projection lands on the half, else distance to an endpoint
    def half_circle_dist(p, center, sign):
        v = p - center
        r = np.linalg.norm(v, axis=1)
        ang = np.arctan2(sign * v[:, 1], sign * v[:, 0])
        on_arc = ang >= 0.0  # [0, π] after the sign flip
        d_circle = np.abs(r - 1.0)
        ends = center + sign * np.array([[1.0, 0.0], [-1.0, 0.0]])
        d_ends = np.minimum(
            np.linalg.norm(p - ends[0], axis=1),
            np.linalg.norm(p - ends[1], axis=1),
        )
        return np.where(on_arc, d_circle, d_ends)

    d_up = half_circle_dist(x, np.array([0.0, 0.0]), +1.0)
    d_lo = half_circle_dist(x, np.array([1.0, 0.5]), -1.0)
    return np.minimum(d_up, d_lo)


def rings(n: int, *, radii=(1.0, 2.0), noise: float = 0.08,
          rng=0) -> np.ndarray:
    """Concentric circles with isotropic Gaussian noise (equal mass per
    ring)."""
    rng = np.random.default_rng(rng)
    radii = np.asarray(radii, np.float64)
    k = len(radii)
    counts = [n // k + (1 if i < n % k else 0) for i in range(k)]
    parts = []
    for r, c in zip(radii, counts):
        a = rng.uniform(0.0, 2.0 * np.pi, c)
        parts.append(np.stack([r * np.cos(a), r * np.sin(a)], axis=1))
    x = np.concatenate(parts).astype(np.float32)
    x += rng.normal(scale=noise, size=x.shape).astype(np.float32)
    return x[rng.permutation(n)]


def rings_manifold_distance(x: np.ndarray, radii=(1.0, 2.0)) -> np.ndarray:
    """Per-point distance to the nearest ring."""
    r = np.linalg.norm(np.asarray(x, np.float64), axis=1)
    return np.min(np.abs(r[:, None] - np.asarray(radii)[None, :]), axis=1)
