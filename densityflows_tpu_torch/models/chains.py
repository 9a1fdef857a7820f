"""Flow chains: ordered composition of flow elements with ldj accumulation.

PyTorch counterpart of ``densityflows_tpu/models/chains.py``:

- ``forward`` folds first→last (latent → data), ``inverse`` folds
  last→first (data → latent), ldj accumulated additively;
- ``forward_`` is the ldj-free sampling sweep; it goes through the
  whole-chain CUDA kernel where the routing policy says so
  (``models/fused_chain.py``);
- ``concatenate`` merges chains and elements.
"""

from __future__ import annotations

from torch import nn

__all__ = ["FlowChain", "flow_chain", "concatenate"]


class FlowChain(nn.Module):
    """Sequence of flow elements."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return FlowChain(list(self.layers)[i])
        return self.layers[i]

    def __iter__(self):
        return iter(self.layers)

    def forward(self, z, theta):
        """latent → data fold, first→last."""
        ldj = None
        for layer in self.layers:
            z, ldj_i = layer.forward(z, theta)
            ldj = ldj_i if ldj is None else ldj + ldj_i
        return z, ldj

    def inverse(self, x, theta):
        """data → latent fold, last→first."""
        ldj = None
        for layer in reversed(self.layers):
            x, ldj_i = layer.inverse(x, theta)
            ldj = ldj_i if ldj is None else ldj + ldj_i
        return x, ldj

    def forward_(self, z, theta):
        """ldj-free sampling sweep."""
        from .fused_chain import maybe_apply_fused

        out = maybe_apply_fused(self, z, theta, "fwd", False)
        if out is not None:
            return out
        for layer in self.layers:
            z = layer.forward_(z, theta)
        return z

    def summarize(self) -> str:
        return "\n".join(layer.summarize() for layer in self.layers)


def flow_chain(*elements) -> FlowChain:
    """Build a chain from elements, or replicate a factory:
    ``flow_chain(factory, n, *args)(**kwargs)`` builds ``n``
    independently-initialized elements (pass one ``generator=`` so each
    element draws its own weights from it)."""
    if elements and callable(elements[0]) and not hasattr(elements[0], "inverse"):
        factory, n, *args = elements

        def build(**kwargs):
            return FlowChain([factory(*args, **kwargs) for _ in range(n)])

        return build
    if len(elements) == 1 and isinstance(elements[0], (tuple, list)):
        elements = tuple(elements[0])
    return FlowChain(list(elements))


def concatenate(*parts) -> FlowChain:
    """Merge chains and elements into one chain."""
    layers = []
    for p in parts:
        if isinstance(p, FlowChain):
            layers.extend(p.layers)
        elif isinstance(p, (tuple, list)):
            for q in p:
                layers.extend(q.layers if isinstance(q, FlowChain) else [q])
        else:
            layers.append(p)
    return FlowChain(layers)
