"""Plain replay of maximum-likelihood training calls with Adam.

A call trains ``epochs`` epochs over its training rows: each epoch takes the
rows in its order (the rows as given, or permuted by the epoch's
permutation), in batches of ``batchsize`` with the last, partial batch kept,
and each batch is one Adam step (Kingma and Ba, 2015; bias-corrected moments,
``eps`` outside the square root, as the configuration's optimizer states it)
on the mean negative log-likelihood of the configuration's reference flow,
by autograd. After each epoch it evaluates the mean NLL of all the call's
training rows and of the validation rows, which is what a training call
reports per epoch. A call either continues the state (weights and moments)
or starts afresh from the first weights with zero moments.

The per-epoch permutations of a shuffled call are drawn as the program
documents them: ``torch.randperm(n)`` per epoch, in order, from a CPU
``torch.Generator`` seeded with the call's seed (:func:`epoch_orders`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp32_exact, module

__all__ = ["epoch_orders", "replay"]


def epoch_orders(gen_seed: int, epochs: int, n: int) -> list[torch.Tensor]:
    """The ``epochs`` row permutations of a shuffled call of ``n`` rows."""
    g = torch.Generator().manual_seed(int(gen_seed))
    return [torch.randperm(n, generator=g) for _ in range(epochs)]


def _nll_blocks(flow, x, theta, block: int) -> float:
    total = 0.0
    with torch.no_grad():
        for r0 in range(0, x.shape[0], block):
            total += float(-flow.log_prob(x[r0:r0 + block],
                                          theta[r0:r0 + block]).double().sum())
    return total / x.shape[0]


def replay(cfg, params0: dict, norm_x, theta_lo, theta_hi, x, theta, calls,
           valid_idx, *, fault: str | None = None, tf32: bool = False,
           block: int = 65536):
    """Replay ``calls`` from ``params0``.

    ``x`` / ``theta``: every raw row; ``valid_idx``: the validation rows'
    indices; each call is a dict with ``idx`` (its training rows' indices,
    in order), ``epochs``, ``gen_seed`` (None: no shuffle) and ``reset``
    (start from ``params0`` with zero moments). ``fault`` plants one in the
    replay: ``"half_batch"`` (each step on the first half of its batch, the
    mean over those rows) or ``"unchanged"`` (no step changes the state).

    Returns ``{"losses": [[(train NLL, valid NLL) per epoch] per call],
    "grad1": {name: tensor}, "params": [{name: tensor} per call]}``: the
    first step's gradient and the weights after each call."""
    opt = cfg["optimizer"]
    lr, b1, b2, eps = (float(opt[k]) for k in ("lr", "b1", "b2", "eps"))
    bs = int(cfg["train"]["batchsize"])
    dev = x.device
    names = list(params0)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    params = [leaves[k] for k in names]
    flow = module(cfg).Reference(cfg, leaves, norm_x, theta_lo, theta_hi)
    vi = torch.as_tensor(valid_idx, device=dev)
    xv, thv = x[vi], theta[vi]
    out = {"losses": [], "grad1": None, "params": []}
    step = 0
    with fp32_exact(tf32):
        for call in calls:
            if call["reset"]:
                with torch.no_grad():
                    for p, k in zip(params, names):
                        p.copy_(params0[k])
                step = 0
            if step == 0:
                mu = [torch.zeros_like(p) for p in params]
                nu = [torch.zeros_like(p) for p in params]
            idx = torch.as_tensor(call["idx"], device=dev)
            xt, tht = x[idx], theta[idx]
            n = idx.shape[0]
            perms = (epoch_orders(call["gen_seed"], call["epochs"], n)
                     if call["gen_seed"] is not None else
                     [None] * call["epochs"])
            out["losses"].append([])
            for perm in perms:
                order = (torch.arange(n, device=dev) if perm is None
                         else perm.to(dev))
                for b0 in range(0, n, bs):
                    rows = order[b0:b0 + bs]
                    if fault == "half_batch":
                        rows = rows[:max(1, rows.shape[0] // 2)]
                    loss = flow.nll(xt[rows], tht[rows])
                    grads = torch.autograd.grad(loss, params)
                    step += 1
                    if out["grad1"] is None:
                        out["grad1"] = {k: g.detach().clone()
                                        for k, g in zip(names, grads)}
                    if fault == "unchanged":
                        continue
                    bc1 = float(np.float32(1.0)
                                - np.float32(b1) ** np.float32(step))
                    bc2 = float(np.float32(1.0)
                                - np.float32(b2) ** np.float32(step))
                    with torch.no_grad():
                        # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g²;
                        # p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)
                        torch._foreach_mul_(mu, b1)
                        torch._foreach_add_(mu, torch._foreach_mul(
                            grads, 1.0 - b1))
                        torch._foreach_mul_(nu, b2)
                        torch._foreach_add_(nu, torch._foreach_mul(
                            torch._foreach_mul(grads, grads), 1.0 - b2))
                        den = torch._foreach_div(nu, bc2)
                        torch._foreach_sqrt_(den)
                        torch._foreach_add_(den, eps)
                        upd = torch._foreach_div(mu, bc1)
                        torch._foreach_div_(upd, den)
                        torch._foreach_mul_(upd, lr)
                        torch._foreach_sub_(params, upd)
                out["losses"][-1].append((_nll_blocks(flow, xt, tht, block),
                                          _nll_blocks(flow, xv, thv, block)))
            out["params"].append({k: v.detach().clone()
                                  for k, v in leaves.items()})
    return out
