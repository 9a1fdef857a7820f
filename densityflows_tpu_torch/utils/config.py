"""Configuration dataclasses with the reference's defaults.

PyTorch counterpart of ``densityflows_tpu/utils/config.py``: the same
dataclasses and defaults, and ``build_flow`` / ``run_experiment`` built on
this package's layers, its ``train`` and its own :class:`~..train.Adam`.

- network shape: hidden 32, 2 sublayers, relu, bias on;
- data split: f_training 0.9, f_validation 0.1;
- training: epochs 100, batch 64, shuffle on, Adam 1e-3.
"""

from __future__ import annotations

import dataclasses

__all__ = ["NetConfig", "DataConfig", "TrainConfig", "FlowConfig",
           "build_flow", "run_experiment"]


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Conditioner-MLP shape."""

    hidden_dim_s: int = 32
    hidden_dim_t: int = 32
    n_sublayers_s: int = 2
    n_sublayers_t: int = 2
    activation_s: str = "relu"
    activation_t: str = "relu"
    bias: bool = True
    # 0.0 = unbounded; > 0 tanh-clamps the RNVP log-scale — ignored by other
    # families
    max_log_scale: float = 0.0
    # rnvp only: ONE two-headed conditioner emitting (s ‖ t)
    joint_conditioner: bool = False

    def layer_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Split fractions."""

    f_training: float = 0.9
    f_validation: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters. ``mixed_precision`` and ``remat`` go to
    ``train`` as they are (the plain program's options)."""

    epochs: int = 100
    batchsize: int = 64
    shuffle: bool = True
    verbose: bool = True
    learning_rate: float = 1e-3
    mixed_precision: bool = False  # bf16 conditioner compute, f32 state
    remat: bool = False            # per-layer activation rematerialization


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """End-to-end experiment config: model + data + training.

    ``family`` selects the block type: ``'rnvp'`` (default, affine
    couplings), ``'nice'`` (additive), ``'rqs'`` (rational-quadratic spline
    couplings, ``n_bins`` knots), or ``'maf'`` (masked autoregressive blocks
    with a permutation between them). ``mix='linear'`` inserts a trainable
    LU-parameterized invertible linear between blocks; ``'permute'`` a fixed
    reversal; ``'none'`` nothing. ``tail`` selects the chain tail:
    ``'normalization'`` (range pin), ``'actnorm'`` (trainable,
    data-initialized), ``'logit'`` (for hard-bounded data), or ``'none'``.
    """

    net: NetConfig = NetConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    n_blocks: int = 3
    family: str = "rnvp"
    mix: str = "none"
    tail: str = "normalization"
    n_bins: int = 8
    norm_alpha: float = -1.0
    norm_beta: float = 1.0


def build_flow(config: FlowConfig, data, *, generator=None, device=None):
    """Construct the flow from a config: ``n_blocks`` blocks of the selected
    ``family`` (each transforming every dim once), optional mixing layers
    between blocks, and the configured tail layer, all on ``device`` with
    weights drawn from ``generator``."""
    from .._device import resolve_device
    from ..models.autoregressive import maf_layer
    from ..models.blocks import coupling_block
    from ..models.chains import flow_chain
    from ..models.flow import Flow
    from ..models.glow import actnorm_layer, invertible_linear_layer
    from ..models.layers import (
        NICECouplingLayer, RNVPCouplingLayer, RQSCouplingLayer,
    )
    from ..models.normalization import (
        logit_layer, normalization_layer, permutation_layer,
    )

    if config.family not in ("rnvp", "nice", "rqs", "maf"):
        raise ValueError(f"unknown family {config.family!r}")
    if config.mix not in ("none", "linear", "permute"):
        raise ValueError(f"unknown mix {config.mix!r}")
    if config.tail not in ("normalization", "actnorm", "logit", "none"):
        raise ValueError(f"unknown tail {config.tail!r}")
    device = resolve_device(device)
    d, n = data.num_dimensions, data.num_conditions

    blocks = []
    for i in range(config.n_blocks):
        if config.family == "maf":
            blocks.append(maf_layer(
                d, n=n, generator=generator,
                hidden_dim=config.net.hidden_dim_t,
                activation=config.net.activation_t, device=device))
        else:
            kind = {"rnvp": RNVPCouplingLayer, "nice": NICECouplingLayer,
                    "rqs": RQSCouplingLayer}[config.family]
            blocks.append(coupling_block(
                data, None, generator=generator, kind=kind,
                n_bins=config.n_bins, device=device,
                **config.net.layer_kwargs()))
        last = i == config.n_blocks - 1
        if config.family == "maf" and not last:
            blocks.append(permutation_layer(d))
        elif config.mix == "linear" and not last:
            blocks.append(invertible_linear_layer(d, generator=generator,
                                                  device=device))
        elif config.mix == "permute" and not last:
            blocks.append(permutation_layer(d))

    tail = {
        "normalization": lambda: [normalization_layer(
            data.x, config.norm_alpha, config.norm_beta, device=device)],
        "actnorm": lambda: [actnorm_layer(data.x, device=device)],
        "logit": lambda: [logit_layer(data.x, margin=0.01, device=device)],
        "none": lambda: [],
    }[config.tail]()
    return Flow(flow_chain(*blocks, *tail), data, device=device)


def run_experiment(config: FlowConfig, x, theta=None, *, generator=None,
                   device=None, mesh=None):
    """Data split → model build → training, all from one config. Returns
    ``(flow, data, opt_state)``. The model's weights and the batch order
    both come from ``generator``."""
    from ..data import DataArrays
    from ..train import Adam, train

    data = DataArrays.make(
        x, theta, f_training=config.data.f_training,
        f_validation=config.data.f_validation, rng=0)
    flow = build_flow(config, data, generator=generator, device=device)
    opt_state = train(
        flow, data, Adam(config.train.learning_rate),
        epochs=config.train.epochs, batchsize=config.train.batchsize,
        shuffle=config.train.shuffle, verbose=config.train.verbose,
        generator=generator, mesh=mesh, remat=config.train.remat,
        mixed_precision=config.train.mixed_precision)
    return flow, data, opt_state
