"""densityflows_tpu_torch — the PyTorch / CUDA port of densityflows_tpu.

The package sits beside the JAX package and mirrors its layout (``ops/``,
``models/``, ``utils/``, plus ``csrc/`` for the CUDA sources), so the
counterpart of a module is found by path. It imports ``torch`` and
``numpy`` only.

Device rule: entry points run on a CUDA device unless the caller asks for
the CPU. ``device=None`` means ``"cuda"`` and raises where CUDA is not
available.

Ported so far: the serving path — ``load_flow`` → ``log_prob`` / ``sample``
/ ``sample_sweep`` / ``forward`` / ``inverse`` — on the hand-written
whole-chain kernels ``chain_apply`` and ``chain_sample``
(``csrc/chain_kernels.cu``), and single-device training — ``train`` →
``train_fused`` on the whole-run kernel ``train_run``
(``csrc/train_kernels.cu``) or, for a model too large for its shared memory,
the streaming whole-run kernel ``train_stream`` (``csrc/stream_kernels.cu``),
with the plain multi-epoch program beside them, and the streaming trainer and the data-parallel step — ``train_streaming``,
``train(mesh=...)`` — on the grads-only step kernel ``step_grads``
(``csrc/step_kernels.cu``), fed by the native host loader
(``csrc/loader.cpp``).
"""

from ._device import resolve_device
from .axes import CouplingAxes, coupling_axes, is_reverse, reverse_axes
from .convert import (
    adam_state_from_jax_leaves,
    adam_state_to_jax_leaves,
    chain_from_spec_and_leaves,
    flow_from_jax_numpy,
)
from . import native
from .data import (
    DataArrays,
    DataPartition,
    MetaData,
    dflt_theta,
    maximum_theta,
    minimum_theta,
    normalize_input,
    number_conditions,
    number_dimensions,
    resize_output,
)
from .data_stream import StreamingLoader, train_streaming
from .models.blocks import CouplingBlock, coupling_block
from .models.chains import FlowChain, concatenate, flow_chain
from .models.distributions import StandardNormal
from .models.flow import Flow, nll_loss
from .models.fused_train import (
    UnsupportedFusedTrain,
    chain_train_fold,
    train_fused,
)
from .models.glow import (
    ActNormLayer,
    InvertibleLinearLayer,
    actnorm_layer,
    invertible_linear_layer,
)
from .models.layers import (
    JointRNVPCouplingLayer,
    NICECouplingLayer,
    RNVPCouplingLayer,
    coupling_layer,
    set_fused_kernels,
)
from .models.normalization import (
    LogitLayer,
    NormalizationLayer,
    PermutationLayer,
    logit_layer,
    normalization_layer,
    permutation_layer,
)
from .ops.coupling import (
    nice_backward,
    nice_forward,
    rnvp_backward,
    rnvp_forward,
)
from .ops.mlp import MLP, apply_mlp, init_mlp
from .parallel.mesh import (
    Mesh,
    distributed_init,
    host_local_rows,
    host_local_slice,
    make_mesh,
    put_replicated,
    shard_batch,
)
from .train import (
    Adam,
    AdamState,
    adam,
    batch_iterator,
    evaluate,
    make_fused_step_fn,
    make_fused_step_mesh_program,
    make_train_program,
    make_train_step,
    masked_nll_loss,
    train,
)
from .utils.checkpoint import (
    load_element,
    load_flow,
    register_element,
    save_element,
    save_flow,
)

__version__ = "0.1.0"


def summarize(obj) -> str:
    """Pretty-print any flow element / chain / flow / data container."""
    return obj.summarize()


__all__ = [
    "resolve_device",
    "CouplingAxes", "coupling_axes", "reverse_axes", "is_reverse",
    "DataArrays", "DataPartition", "MetaData", "dflt_theta",
    "minimum_theta", "maximum_theta", "normalize_input", "resize_output",
    "number_dimensions", "number_conditions",
    "MLP", "init_mlp", "apply_mlp",
    "rnvp_forward", "rnvp_backward", "nice_forward", "nice_backward",
    "RNVPCouplingLayer", "NICECouplingLayer", "JointRNVPCouplingLayer",
    "coupling_layer", "set_fused_kernels",
    "NormalizationLayer", "normalization_layer",
    "PermutationLayer", "permutation_layer",
    "LogitLayer", "logit_layer",
    "ActNormLayer", "actnorm_layer",
    "InvertibleLinearLayer", "invertible_linear_layer",
    "CouplingBlock", "coupling_block",
    "FlowChain", "flow_chain", "concatenate",
    "StandardNormal",
    "Flow", "nll_loss",
    "summarize",
    "save_flow", "load_flow", "save_element", "load_element",
    "register_element",
    "chain_from_spec_and_leaves", "flow_from_jax_numpy",
    "adam_state_from_jax_leaves", "adam_state_to_jax_leaves",
    "train", "evaluate", "make_train_step", "make_train_program",
    "batch_iterator", "masked_nll_loss", "Adam", "AdamState", "adam",
    "UnsupportedFusedTrain", "chain_train_fold", "train_fused",
    "make_fused_step_fn", "make_fused_step_mesh_program",
    "native", "StreamingLoader", "train_streaming",
    "Mesh", "make_mesh", "distributed_init", "host_local_rows",
    "host_local_slice", "shard_batch", "put_replicated",
]
