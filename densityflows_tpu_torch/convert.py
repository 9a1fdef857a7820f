"""Carry weights and state across from the JAX package, through numpy.

The JAX package describes an element by its ``element_spec`` dictionary and
holds its arrays as pytree leaves. These functions build this package's
modules from such a spec and the leaves as numpy arrays (in pytree-flatten
order, which is the field order listed in ``utils/checkpoint.py``). Nothing
here imports JAX: the caller takes the spec and the leaves from the JAX
side. ``utils.checkpoint.load_flow`` is the same thing from disk.

Optimizer state crosses the same way: ``adam_state_from_jax_leaves`` takes
the leaves of the JAX package's ``optax.adam`` state as numpy arrays (in
``jax.tree_util.tree_leaves`` order, which is also the order of
``opt_state.npz``) and ``adam_state_to_jax_leaves`` gives them back. The JAX
state has a (zero) moment for every pytree leaf, the non-trainable
``NormalizationLayer.x_min`` / ``x_max`` included; here those are buffers
with no moments, so they are dropped one way and filled with zeros the other.
"""

from __future__ import annotations

import numpy as np

from ._device import resolve_device
from .data import MetaData
from .models.flow import Flow
from .utils.checkpoint import (
    adam_state_from_leaves,
    adam_state_to_leaves,
    element_from_spec,
    set_element_leaves,
)

__all__ = ["chain_from_spec_and_leaves", "flow_from_jax_numpy",
           "adam_state_from_jax_leaves", "adam_state_to_jax_leaves"]


def chain_from_spec_and_leaves(spec: dict, leaves, device=None):
    """Build the element (a chain, a layer, an MLP, a base distribution)
    that ``spec`` describes, on ``device``, with its arrays set from
    ``leaves``."""
    device = resolve_device(device)
    el = element_from_spec(spec, device)
    set_element_leaves(el, [np.asarray(a) for a in leaves])
    return el


def flow_from_jax_numpy(model_spec, model_leaves, base_spec, base_leaves,
                        metadata, device=None, *, train_loss=None,
                        valid_loss=None) -> Flow:
    """Build a :class:`Flow` from the JAX package's model and base specs and
    leaves. ``metadata``: a :class:`MetaData`, or any object / dict with
    ``hash``, ``d``, ``n``, ``theta_min``, ``theta_max``."""
    device = resolve_device(device)
    if not isinstance(metadata, MetaData):
        get = (metadata.get if isinstance(metadata, dict)
               else lambda k: getattr(metadata, k))
        metadata = MetaData(get("hash"), int(get("d")), int(get("n")),
                            np.asarray(get("theta_min"), np.float32),
                            np.asarray(get("theta_max"), np.float32))
    model = chain_from_spec_and_leaves(model_spec, model_leaves, device)
    base = chain_from_spec_and_leaves(base_spec, base_leaves, device)
    return Flow(model, metadata, base, train_loss, valid_loss, device=device)


def adam_state_from_jax_leaves(model, leaves):
    """This package's Adam state for ``model`` from the leaves of the JAX
    package's Adam state (numpy arrays: count, then mu and nu over every
    model leaf)."""
    return adam_state_from_leaves(model, leaves)


def adam_state_to_jax_leaves(model, opt_state) -> list:
    """The leaves of the JAX package's Adam state (numpy arrays, in
    ``tree_leaves`` order) from this package's state for ``model``."""
    return adam_state_to_leaves(model, opt_state)
