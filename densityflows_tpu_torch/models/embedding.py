"""Learned condition embeddings (summary networks) for conditional flows.

PyTorch counterpart of ``densityflows_tpu/models/embedding.py``: a trainable
embedding MLP maps the raw conditions to a compact summary vector, learned
jointly with the flow by the same NLL objective. :class:`EmbeddedChain`
wraps a model chain, transforms ``theta`` once per call and forwards the
flow element protocol (``forward`` / ``inverse`` / ``forward_``), so
``Flow``, ``train`` (embedding gradients included), sampling and
checkpoints take it as they take a chain. θ is normalized at the ``Flow``
boundary first: the embedding sees normalized conditions.

Routing follows the JAX package: sampling runs ``forward_`` of the inner
:class:`~densityflows_tpu_torch.models.chains.FlowChain` on the embedded θ,
which takes the ``chain_apply`` kernel where the chain is fusable; density
evaluation stays per-layer, since the model is not a ``FlowChain``.
"""

from __future__ import annotations

from torch import nn

from .._device import resolve_device
from ..ops.mlp import MLP, apply_mlp, count_params, init_mlp

__all__ = ["EmbeddedChain", "embed_conditions"]


class EmbeddedChain(nn.Module):
    """Model chain whose conditions pass through a trainable embedding MLP.
    The layers of ``chain`` are built for ``n = embed_dim`` conditions (the
    embedding's output width), not the raw condition width."""

    def __init__(self, embed: MLP, chain):
        super().__init__()
        self.embed = embed
        self.chain = chain

    def _e(self, theta):
        return apply_mlp(self.embed, theta)

    def forward(self, z, theta):
        return self.chain.forward(z, self._e(theta))

    def inverse(self, x, theta):
        return self.chain.inverse(x, self._e(theta))

    def forward_(self, z, theta):
        return self.chain.forward_(z, self._e(theta))

    def __len__(self) -> int:
        return len(self.chain)

    def __iter__(self):
        return iter(self.chain)

    @property
    def layers(self):
        return self.chain.layers

    def summarize(self) -> str:
        return (f"ConditionEmbedding | {list(self.embed.dims)} "
                f"({count_params(self.embed)} parameters)\n"
                + self.chain.summarize())


def embed_conditions(chain, n_raw: int, embed_dim: int, *, generator=None,
                     n_sublayers: int = 2, hidden_dim: int = 64,
                     activation: str = "relu", device=None) -> EmbeddedChain:
    """Wrap ``chain`` with a fresh ``n_raw → embed_dim`` embedding MLP
    (glorot-uniform from ``generator``). ``chain``'s layers must have been
    built with ``n = embed_dim``."""
    embed = init_mlp(generator, n_raw, embed_dim, n_sublayers,
                     hidden_dim=hidden_dim, activation=activation,
                     device=resolve_device(device))
    return EmbeddedChain(embed, chain)
