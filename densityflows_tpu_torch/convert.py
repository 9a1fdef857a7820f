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

Ensembles cross as the JAX ``EnsembleFlow`` holds them: the member spec, the
stacked leaves (every leaf with a leading K axis) as numpy arrays, the base
and the ``(epochs, K)`` histories (``ensemble_from_jax_numpy``);
``ensemble_to_jax_numpy`` gives the same pieces back.
"""

from __future__ import annotations

import numpy as np

from ._device import resolve_device
from .data import MetaData
from .models.flow import Flow
from .utils.checkpoint import (
    _leaf_array,
    adam_state_from_leaves,
    adam_state_to_leaves,
    element_from_spec,
    element_leaves,
    element_spec,
    set_element_leaves,
)

__all__ = ["chain_from_spec_and_leaves", "flow_from_jax_numpy",
           "ensemble_from_jax_numpy", "ensemble_to_jax_numpy",
           "adam_state_from_jax_leaves", "adam_state_to_jax_leaves"]


def chain_from_spec_and_leaves(spec: dict, leaves, device=None):
    """Build the element (a chain, a layer, an MLP, a base distribution)
    that ``spec`` describes, on ``device``, with its arrays set from
    ``leaves``."""
    device = resolve_device(device)
    el = element_from_spec(spec, device)
    set_element_leaves(el, [np.asarray(a) for a in leaves])
    return el


def _as_metadata(metadata) -> MetaData:
    if isinstance(metadata, MetaData):
        return metadata
    get = (metadata.get if isinstance(metadata, dict)
           else lambda k: getattr(metadata, k))
    return MetaData(get("hash"), int(get("d")), int(get("n")),
                    np.asarray(get("theta_min"), np.float32),
                    np.asarray(get("theta_max"), np.float32))


def flow_from_jax_numpy(model_spec, model_leaves, base_spec, base_leaves,
                        metadata, device=None, *, train_loss=None,
                        valid_loss=None) -> Flow:
    """Build a :class:`Flow` from the JAX package's model and base specs and
    leaves. ``metadata``: a :class:`MetaData`, or any object / dict with
    ``hash``, ``d``, ``n``, ``theta_min``, ``theta_max``."""
    device = resolve_device(device)
    metadata = _as_metadata(metadata)
    model = chain_from_spec_and_leaves(model_spec, model_leaves, device)
    base = chain_from_spec_and_leaves(base_spec, base_leaves, device)
    return Flow(model, metadata, base, train_loss, valid_loss, device=device)


def ensemble_from_jax_numpy(member_spec, stacked_leaves, base_spec,
                            base_leaves, metadata, n_members, device=None, *,
                            train_loss=None, valid_loss=None):
    """Build an :class:`~densityflows_tpu_torch.ensemble.EnsembleFlow` from
    the pieces of the JAX package's: the spec of one member, the stacked
    leaves (each with a leading K axis) as numpy arrays in pytree order, the
    base's spec and leaves, the metadata and the ``(epochs, K)``
    histories."""
    from .ensemble import EnsembleFlow, StackedModels

    device = resolve_device(device)
    stacked = [np.asarray(a) for a in stacked_leaves]
    members = [chain_from_spec_and_leaves(member_spec,
                                          [a[i] for a in stacked], device)
               for i in range(int(n_members))]
    base = chain_from_spec_and_leaves(base_spec, base_leaves, device)
    return EnsembleFlow(StackedModels(members), _as_metadata(metadata), base,
                        int(n_members), train_loss=train_loss,
                        valid_loss=valid_loss, device=device)


def ensemble_to_jax_numpy(ens) -> dict:
    """The pieces :func:`ensemble_from_jax_numpy` takes, from this package's
    ensemble: ``member_spec``, ``stacked_leaves`` (numpy, a leading K axis;
    a bfloat16 leaf as its raw 2-byte values), ``base_spec``,
    ``base_leaves``, ``metadata`` (a dict), ``n_members``, ``train_loss``,
    ``valid_loss``."""
    md = ens.metadata
    return dict(
        member_spec=element_spec(ens.model[0]),
        stacked_leaves=[_leaf_array(t) for t in ens.model.leaves()],
        base_spec=element_spec(ens.base),
        base_leaves=[_leaf_array(t) for t in element_leaves(ens.base)],
        metadata=dict(hash=md.hash, d=md.d, n=md.n,
                      theta_min=np.asarray(md.theta_min),
                      theta_max=np.asarray(md.theta_max)),
        n_members=ens.n_members,
        train_loss=[list(r) for r in ens.train_loss],
        valid_loss=[list(r) for r in ens.valid_loss])


def adam_state_from_jax_leaves(model, leaves):
    """This package's Adam state for ``model`` from the leaves of the JAX
    package's Adam state (numpy arrays: count, then mu and nu over every
    model leaf)."""
    return adam_state_from_leaves(model, leaves)


def adam_state_to_jax_leaves(model, opt_state) -> list:
    """The leaves of the JAX package's Adam state (numpy arrays, in
    ``tree_leaves`` order) from this package's state for ``model``."""
    return adam_state_to_leaves(model, opt_state)
