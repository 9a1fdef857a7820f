"""The system under test: ``densityflows_tpu_torch`` built from a
configuration by its kind (``kinds/<kind>.py``) through the program's public
constructors, with the benchmark's weights copied in, and the counters that
record which route a call took.

Only this module and the kind modules import the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kinds

__all__ = ["build_flow", "port_leaves", "load_leaves", "route", "reset_route",
           "data_arrays", "load_kernels"]


def _dt():
    import densityflows_tpu_torch as dt

    return dt


def load_kernels(cfg, use: str) -> dict:
    """Build (first run of a checkout) or load the CUDA libraries that the
    kind of ``cfg`` names for the generator ``use`` from the program's
    ``build/`` directory; seconds per library."""
    from densityflows_tpu_torch._build import load_libraries

    return load_libraries(kinds.module(cfg).KERNELS.get(use, ()))


def build_flow(cfg, leaves: dict, problem, device):
    """A ``Flow`` of ``cfg`` on ``device`` holding ``leaves`` (name →
    tensor), built by the configuration's kind (``kinds/<kind>.py``)."""
    return kinds.module(cfg).build(cfg, leaves, problem, device)


def port_leaves(cfg, flow) -> dict:
    """name → the flow's ``nn.Parameter`` of that name (the kind's
    reference ``param_layout`` names)."""
    return kinds.module(cfg).leaves(cfg, flow)


def load_leaves(cfg, flow, leaves: dict) -> None:
    params = port_leaves(cfg, flow)
    if set(params) != set(leaves):
        raise ValueError("the flow's leaves differ from the configuration's")
    with torch.no_grad():
        names = list(leaves)
        torch._foreach_copy_([params[k].data for k in names],
                             [leaves[k] for k in names])


def leaf_names_in_state_order(cfg, flow) -> list[str]:
    """The names of ``AdamState.mu`` / ``nu``'s entries, in their order."""
    from densityflows_tpu_torch.models.fused_train import trainable_leaves

    by_id = {id(p): k for k, p in port_leaves(cfg, flow).items()}
    return [by_id[id(p)] for p in trainable_leaves(flow.model)]


def data_arrays(x: np.ndarray, theta: np.ndarray, train_idx, valid_idx):
    """A ``DataArrays`` over host rows with the harness's own split (the
    training rows in the order the calls are to take them)."""
    dt = _dt()
    part = dt.DataPartition(np.asarray(train_idx), np.asarray(valid_idx),
                            np.zeros(0, np.int64))
    return dt.DataArrays(x, theta, part)


def reset_route() -> None:
    from densityflows_tpu_torch.ops import chain_kernels, stream_kernels, \
        train_kernels

    chain_kernels.reset_launch_counts()
    train_kernels.run_fused_train.launches = 0
    stream_kernels.run_fused_train_stream.launches = 0


def route(flow=None) -> dict:
    """Launch counters since :func:`reset_route` and the flow's recorded
    training route."""
    from densityflows_tpu_torch.ops import chain_kernels, stream_kernels, \
        train_kernels

    out = dict(chain_kernels.launch_counts())
    out["train_run"] = train_kernels.run_fused_train.launches
    out["train_stream"] = stream_kernels.run_fused_train_stream.launches
    if flow is not None:
        out["trained_path"] = flow.trained_path
        out["fused_kernel_mode"] = flow.fused_kernel_mode
        out["fused_decline_reason"] = flow.fused_decline_reason
    return out
