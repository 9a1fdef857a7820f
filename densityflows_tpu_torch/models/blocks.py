"""Coupling blocks: a pair of layers with complementary masks.

PyTorch counterpart of ``densityflows_tpu/models/blocks.py``: two coupling
layers whose axes are exact complements, so every feature dim is transformed
exactly once per block. ``forward`` applies layer_1 then layer_2;
``inverse`` applies layer_2 then layer_1; ldjs add.
"""

from __future__ import annotations

from torch import nn

from ..axes import CouplingAxes, coupling_axes, is_reverse
from .layers import RNVPCouplingLayer, coupling_layer

__all__ = ["CouplingBlock", "coupling_block"]


class CouplingBlock(nn.Module):
    """Two complementary coupling layers."""

    def __init__(self, layer_1, layer_2):
        super().__init__()
        if not is_reverse(layer_1.axes, layer_2.axes):
            raise ValueError(
                "layer_1 and layer_2 need to have complementary axes"
            )
        self.layer_1, self.layer_2 = layer_1, layer_2

    def __len__(self) -> int:
        return 2

    def forward(self, z, theta):
        y, ldj_1 = self.layer_1.forward(z, theta)
        x, ldj_2 = self.layer_2.forward(y, theta)
        return x, ldj_1 + ldj_2

    def inverse(self, x, theta):
        y, ldj_2 = self.layer_2.inverse(x, theta)
        z, ldj_1 = self.layer_1.inverse(y, theta)
        return z, ldj_1 + ldj_2

    def forward_(self, z, theta):
        return self.layer_2.forward_(self.layer_1.forward_(z, theta), theta)

    def summarize(self) -> str:
        return self.layer_1.summarize() + "\n" + self.layer_2.summarize()


def coupling_block(
    d_or_axes_or_data,
    mask=None,
    *,
    kind: type = RNVPCouplingLayer,
    n: int = 0,
    reverse: bool = False,
    **layer_kwargs,
) -> CouplingBlock:
    """Build a block from one axes spec and its complement. Accepts the same
    first-argument forms and keywords (``generator``, ``device``, the net
    hyperparameters) as
    :func:`~densityflows_tpu_torch.models.layers.coupling_layer`."""
    from ..data import DataArrays

    if isinstance(d_or_axes_or_data, CouplingAxes):
        first_axes = d_or_axes_or_data
    elif isinstance(d_or_axes_or_data, DataArrays):
        data = d_or_axes_or_data
        first_axes = coupling_axes(
            data.num_dimensions, mask, n=data.num_conditions, reverse=reverse
        )
    else:
        first_axes = coupling_axes(int(d_or_axes_or_data), mask, n=n, reverse=reverse)

    layer_1 = coupling_layer(first_axes, kind=kind, **layer_kwargs)
    layer_2 = coupling_layer(first_axes.reverse(), kind=kind, **layer_kwargs)
    return CouplingBlock(layer_1, layer_2)
