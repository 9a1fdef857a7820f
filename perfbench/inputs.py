"""Inputs of a run, made from ``--seed``: the weights, the data, the prior box
and the pools that requests are cut from.

Everything is drawn on the run's device with a ``torch.Generator`` of its
own per stream, in a few large calls. Both the program and the reference are
handed these tensors (or host copies of them); neither makes its own.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from . import reference

__all__ = ["sub_seed", "generator", "draw_weights", "Problem"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def draw_weights(cfg, seed: int, device, *tags):
    """The flat weight vector of the kind's reference ``param_layout`` (one
    uniform draw, scaled per leaf) and a name → view dict of it."""
    layout = reference.module(cfg).param_layout(cfg)
    w = cfg["weights"]
    sizes, scales = [], []
    for _, shape, role in layout:
        sizes.append(math.prod(shape))
        if role == "bias":
            scales.append(float(w["bias_scale"]))
        else:
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            scales.append(limit * (float(w["final_scale"])
                                   if role == "final" else 1.0))
    g = generator(seed, device, "weights", *tags)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    flat *= torch.repeat_interleave(
        torch.tensor(scales, dtype=torch.float32, device=device),
        torch.tensor(sizes, device=device))
    views = {name: v.view(shape) for (name, shape, _), v in
             zip(layout, flat.split(sizes))}
    return flat, views


def _simulate(cfg, seed, rows, device, tag, lo, hi):
    """``rows`` draws of the seeded simulator: θ uniform over the prior box,
    ``x = tanh(θ_n A + a) B + noise · ε``. The simulator's own constants
    (A, a, B) come from the run's seed, so every stream of one run samples
    one simulator."""
    data = cfg["data"]
    n, d, width = cfg["n_cond"], cfg["d"], int(data["width"])
    gc = generator(seed, device, "simulator")
    a_mat = torch.randn(n, width, generator=gc, device=device) * 2.0
    a_vec = torch.rand(width, generator=gc, device=device) * 2.0 - 1.0
    b_mat = torch.randn(width, d, generator=gc, device=device) \
        / math.sqrt(width)
    g = generator(seed, device, tag)
    u = torch.rand(rows, n, generator=g, device=device)
    eps = torch.randn(rows, d, generator=g, device=device)
    x = torch.tanh(u @ a_mat + a_vec) @ b_mat + float(data["noise"]) * eps
    return x.contiguous(), (lo + (hi - lo) * u).contiguous()


class Problem:
    """One configuration's data under one seed: the prior box, the rows the
    normalization layer is built from, and :meth:`rows` / :meth:`near_rows`
    to draw more."""

    def __init__(self, cfg, seed: int, device):
        self.cfg, self.seed, self.device = cfg, int(seed), device
        data = cfg["data"]
        if data["kind"] == "file":
            f = np.load(os.path.join(ROOT, data["file"]))
            self.file_x = torch.as_tensor(f["x"], dtype=torch.float32).to(device)
            self.file_theta = torch.as_tensor(
                f["theta"], dtype=torch.float32).to(device)
        box = cfg["theta_box"]
        if box == "data":
            self.theta_lo = self.file_theta.min(0).values
            self.theta_hi = self.file_theta.max(0).values
        else:
            self.theta_lo = torch.tensor(box["lo"], dtype=torch.float32,
                                         device=device)
            self.theta_hi = torch.tensor(box["hi"], dtype=torch.float32,
                                         device=device)
        if data["kind"] == "file":
            self.norm_x = self.file_x
        else:
            self.norm_x, _ = self.rows(int(cfg["normalization"]["rows"]),
                                       "norm")

    def rows(self, count: int, tag: str):
        """``(x, θ)`` of ``count`` fresh rows from the stream ``tag``."""
        if self.cfg["data"]["kind"] == "file":
            raise ValueError("a file's data set has a fixed number of rows")
        return _simulate(self.cfg, self.seed, count, self.device, tag,
                         self.theta_lo, self.theta_hi)

    def near_rows(self, count: int, tag: str):
        """``count`` rows near the data: for a simulator, fresh draws; for a
        file, its rows (uniform) plus Gaussian noise of ``noise`` times each
        dim's spread, with the row's own θ."""
        if self.cfg["data"]["kind"] != "file":
            return self.rows(count, tag)
        g = generator(self.seed, self.device, tag)
        idx = torch.randint(0, self.file_x.shape[0], (count,), generator=g,
                            device=self.device)
        spread = self.file_x.std(0) * float(self.cfg["data"]["noise"])
        x = self.file_x[idx] + spread * torch.randn(
            count, self.file_x.shape[1], generator=g, device=self.device)
        return x.contiguous(), self.file_theta[idx].contiguous()

    def uniform_theta(self, count: int, tag: str):
        """``count`` θ points uniform over the prior box."""
        g = generator(self.seed, self.device, tag)
        u = torch.rand(count, self.cfg["n_cond"], generator=g,
                       device=self.device)
        return (self.theta_lo + (self.theta_hi - self.theta_lo) * u).contiguous()

    def split(self, n_rows: int):
        """The training / validation index split of ``n_rows`` rows, drawn
        from the seed (numpy int64 arrays)."""
        tr = self.cfg["train"]
        perm = np.random.default_rng(sub_seed(self.seed, "split")).permutation(
            n_rows)
        i1 = round(n_rows * float(tr["f_training"]))
        i2 = i1 + round(n_rows * float(tr["f_validation"]))
        return perm[:i1], perm[i1:i2]
