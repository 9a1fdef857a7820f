"""Kind ``realnvp_flow``: a conditional RealNVP chain of split ``s`` / ``t``
conditioners (``coupling_layer``, or ``coupling_block`` pairs where the
configuration says ``blocks``), then a normalization layer, a standard
normal base. Its reference is ``reference/realnvp_flow.py``."""

from __future__ import annotations

import math

import torch

from ..reference.realnvp_flow import param_layout
from ..work import F32

__all__ = ["KERNELS", "build", "leaves", "Work"]

KERNELS = {"serve": ("chain_kernels",),
           "train": ("train_kernels", "stream_kernels")}


def build(cfg, leaves_: dict, problem, device):
    """A ``Flow`` of ``cfg`` on ``device`` holding ``leaves_``, the
    normalization layer built from ``problem.norm_x``, θ normalized over the
    prior box."""
    import densityflows_tpu_torch as dt

    from ..system import load_leaves

    d, n = cfg["d"], cfg["n_cond"]
    kw = dict(n=n, hidden_dim_s=cfg["hidden"], hidden_dim_t=cfg["hidden"],
              n_sublayers_s=cfg["n_sublayers"], n_sublayers_t=cfg["n_sublayers"],
              activation_s=cfg["activation"], activation_t=cfg["activation"],
              zero_init_final=True, generator=torch.Generator(device=device),
              device=device)
    masks = [c["transform"] for c in cfg["couplings"]]
    if cfg["blocks"]:
        elements = [dt.coupling_block(d, masks[i], **kw)
                    for i in range(0, len(masks), 2)]
    else:
        elements = [dt.coupling_layer(d, m, **kw) for m in masks]
    norm = cfg["normalization"]
    elements.append(dt.normalization_layer(
        problem.norm_x.cpu().numpy(), norm["alpha"], norm["beta"],
        device=device))
    meta = dt.MetaData("", d, n, problem.theta_lo.cpu().numpy(),
                       problem.theta_hi.cpu().numpy())
    flow = dt.Flow(dt.flow_chain(*elements), meta, device=device)
    load_leaves(cfg, flow, leaves_)
    return flow


def leaves(cfg, flow) -> dict:
    """name → the flow's ``nn.Parameter`` of :func:`param_layout`'s name."""
    layers = []
    for el in list(flow.model.layers)[:-1]:
        layers += [el.layer_1, el.layer_2] if cfg["blocks"] else [el]
    out = {}
    for ci, layer in enumerate(layers):
        for net_name, net in (("s", layer.s_net), ("t", layer.t_net)):
            for li, (w, b) in enumerate(zip(net.weights, net.biases)):
                out[f"c{ci}.{net_name}.w{li}"] = w
                out[f"c{ci}.{net_name}.b{li}"] = b
    return out


class Work:
    """The work of a ``realnvp_flow`` configuration's entry points."""

    def __init__(self, cfg):
        layout = param_layout(cfg)
        self.d, self.n = cfg["d"], cfg["n_cond"]
        # multiply-adds of one row's forward (or inverse) pass
        self.macs = sum(shape[0] * shape[1] for _, shape, role in layout
                        if role != "bias")
        self.params = sum(math.prod(shape) for _, shape, _ in layout)

    def logprob(self, rows: int) -> tuple[float, float]:
        """``(operations, bytes)`` of ``log_prob`` over ``rows`` rows: x and
        θ read, one log-density written, the weights read."""
        return (2.0 * self.macs * rows,
                F32 * (rows * (self.d + self.n + 1) + self.params))

    def sample(self, rows: int, grid: int) -> tuple[float, float]:
        """``(operations, bytes)`` of a sampling sweep of ``rows`` draws over
        ``grid`` θ points: the grid read, the draws written, the weights
        read."""
        return (2.0 * self.macs * rows,
                F32 * (grid * self.n + rows * self.d + self.params))

    def train(self, rows: int, steps: int) -> tuple[float, float]:
        """``(operations, bytes)`` of ``steps`` Adam steps over ``rows``
        training rows: 3 × the forward products per row; the rows read once,
        and per step the weights and both moments read and written."""
        return (3.0 * 2.0 * self.macs * rows,
                F32 * (rows * (self.d + self.n) + steps * 6 * self.params))
