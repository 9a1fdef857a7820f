"""Kind ``dingo_nsf``: Dingo's neural spline flow (nflows' RQ-spline
couplings with residual, context-gated, batch-normed conditioners, LU
mixing, random permutations), a standard normal base. Its reference is
``reference/dingo_nsf.py``; the equations and conventions are there."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.dingo_nsf import param_layout, step_axes
from ..work import F32

__all__ = ["KERNELS", "build", "leaves", "Work"]

# no CUDA library of the program: the plain training program runs this flow
KERNELS = {}

# what the program's constructors fix, as the configuration must state it
_FIXED = {"activation": "elu", "dropout_probability": 0.0,
          "base_transform_type": "rq-coupling", "batch_norm_eps": 1e-3,
          "batch_norm_momentum": 0.1, "lu_eps": 1e-3, "min_bin_width": 1e-3,
          "min_bin_height": 1e-3, "min_derivative": 1e-3}


def build(cfg, leaves_: dict, problem, device):
    """A ``Flow`` of ``cfg`` on ``device`` holding ``leaves_``: per step a
    permutation layer, an LU linear layer and a spline coupling with a
    residual conditioner, then the last permutation and LU layer, in
    nflows' data → noise order (the program's chain lists its layers
    noise → data, so the list is reversed)."""
    import densityflows_tpu_torch as dt

    from ..system import load_leaves

    for key, value in _FIXED.items():
        if cfg[key] != value:
            raise ValueError(f"the program builds {key} = {value!r}, the "
                             f"configuration states {cfg[key]!r}")
    d, n = int(cfg["d"]), int(cfg["n_cond"])
    gen = torch.Generator(device=device)

    def perm(i):
        # the program's permutation layer maps data → latent by its
        # inverse: y = x[:, argsort(perm)], so perm = argsort(p) gives
        # y[:, j] = x[:, p[j]]
        return dt.permutation_layer(
            np.argsort(np.asarray(cfg["permutations"][i])).tolist())

    steps = int(cfg["num_flow_steps"])
    elements = []
    for i in range(steps):
        _, af = step_axes(cfg, i)
        elements += [perm(i), dt.lu_linear_layer(d, device=device),
                     dt.coupling_layer(
                         d, af, kind=dt.RQSCouplingLayer, n=n,
                         conditioner="residual",
                         batch_norm=bool(cfg["batch_norm"]),
                         n_sublayers_t=int(cfg["num_transform_blocks"]),
                         hidden_dim_t=int(cfg["hidden_dim"]),
                         activation_t=cfg["activation"],
                         n_bins=int(cfg["num_bins"]),
                         bound=float(cfg["tail_bound"]), spline_on="density",
                         zero_init_final=False, generator=gen,
                         device=device)]
    elements += [perm(steps), dt.lu_linear_layer(d, device=device)]
    meta = dt.MetaData("", d, n, problem.theta_lo.cpu().numpy(),
                       problem.theta_hi.cpu().numpy())
    flow = dt.Flow(dt.flow_chain(*reversed(elements)), meta, device=device)
    load_leaves(cfg, flow, leaves_)
    return flow


def leaves(cfg, flow) -> dict:
    """name → the flow's ``nn.Parameter`` of :func:`param_layout`'s name."""
    out, lu_i, c_i = {}, 0, 0
    for layer in reversed(list(flow.model.layers)):
        kind = type(layer).__name__
        if kind == "LULinearLayer":
            for key, p in (("lower", layer.lower), ("upper", layer.upper),
                           ("diag", layer.unconstrained_diag),
                           ("bias", layer.bias)):
                out[f"lu{lu_i}.{key}"] = p
            lu_i += 1
        elif kind == "RQSCouplingLayer":
            net, c = layer.p_net, f"c{c_i}"
            out[f"{c}.w_in"], out[f"{c}.b_in"] = net.w_in, net.b_in
            for j, block in enumerate(net.blocks):
                blk = f"{c}.blk{j}"
                for k, norm in enumerate(block.norms):
                    out[f"{blk}.bn{k}.weight"] = norm.weight
                    out[f"{blk}.bn{k}.bias"] = norm.bias
                out[f"{blk}.w_a"], out[f"{blk}.b_a"] = block.w0, block.b0
                out[f"{blk}.w_b"], out[f"{blk}.b_b"] = block.w1, block.b1
                out[f"{blk}.w_c"], out[f"{blk}.b_c"] = block.wc, block.bc
            out[f"{c}.w_out"], out[f"{c}.b_out"] = net.w_out, net.b_out
            c_i += 1
    return out


class Work:
    """The work of a ``dingo_nsf`` configuration's entry points: the
    conditioners' products and the LU products (d × d a step and the last
    one); the splines, batch norms and gates are elementwise."""

    def __init__(self, cfg):
        layout = param_layout(cfg)
        self.d, self.n = int(cfg["d"]), int(cfg["n_cond"])
        steps = int(cfg["num_flow_steps"])
        # multiply-adds of one row's forward pass
        self.macs = sum(shape[0] * shape[1] for _, shape, role in layout
                        if role != "bias") + (steps + 1) * self.d * self.d
        self.params = sum(math.prod(shape) for _, shape, _ in layout)

    def logprob(self, rows: int) -> tuple[float, float]:
        """``(operations, bytes)`` of ``log_prob`` over ``rows`` rows."""
        return (2.0 * self.macs * rows,
                F32 * (rows * (self.d + self.n + 1) + self.params))

    def sample(self, rows: int, grid: int) -> tuple[float, float]:
        """``(operations, bytes)`` of a sampling sweep of ``rows`` draws over
        ``grid`` context points."""
        return (2.0 * self.macs * rows,
                F32 * (grid * self.n + rows * self.d + self.params))

    def train(self, rows: int, steps: int) -> tuple[float, float]:
        """``(operations, bytes)`` of ``steps`` Adam steps over ``rows``
        training rows: 3 × the forward products per row; the rows read once,
        and per step the weights and both moments read and written."""
        return (3.0 * 2.0 * self.macs * rows,
                F32 * (rows * (self.d + self.n) + steps * 6 * self.params))
