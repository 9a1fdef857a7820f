"""Whole-run training on folded parameters: the ``train_run`` CUDA kernel's
wrapper, its plain PyTorch version, and the lowering between them.

PyTorch/CUDA counterpart of ``densityflows_tpu/ops/pallas_train.py``. One call
runs a whole multi-epoch training run: per batch the inverse fold with
activation caches, the masked (optionally importance-weighted) Gaussian NLL, a
hand-derived backward, select-masked gradients, the non-finite guard and the
Adam update; per epoch the full-split train and validation NLL and the
best-validation snapshot.

The module is layer-agnostic. It executes a *plan* against a flat list of
*folded* trainable tensors (built by ``models/fused_train.py``):

- ``("coupling", kind, "inv", n_s, n_t, act_s, act_t, bias_s, bias_t, has_th,
  has_id, clamp)`` — kind ``"nvp"`` / ``"nice"`` / ``"joint"``, the layout of
  ``ops/chain_kernels.py`` (first dense layer pre-split into a θ block and a
  zero-padded x block, final layer scattered to d columns). Activations are
  the value-differentiable ones: relu, tanh, sigmoid, identity.
- ``("anorm",)`` — trainable ActNorm, params ``log_scale`` (1, d), ``bias``
  (1, d); inverse direction ``z = (x − b)·eˢ``, ldj ``+= Σs``.
- ``("affine",)`` — Normalization constants ``a``, ``b`` (1, d), ``c`` (1, 1),
  not trained.

Training on folded parameters is training on the originals: the fold is a
fixed zero-padding embedding, off-support entries start at 0 and their
gradients are set to 0 by static 0/1 masks (a select, not a multiply) before
the Adam moments, so they stay 0; on-support entries see the same gradients.

Three implementations of the same run:

- ``fused_train_plain`` — plain PyTorch on the folded tensors, with the same
  hand-derived backward (no autograd). The reference of the kernel.
- ``packed_train_reference`` — executes, in PyTorch, the flat instruction
  program that ``pack_train_plan`` lowers a plan to. It checks the lowering
  (offsets, buffer routing) where there is no GPU.
- ``run_fused_train`` — the wrapper. On CUDA tensors it launches the
  ``train_run`` kernel of ``csrc/train_kernels.cu`` (one persistent thread
  block; parameters, moments and one batch's activations in shared memory;
  it replaces ``densityflows_tpu/ops/pallas_train.py::_train_kernel``) or
  raises; on CPU tensors it runs ``fused_train_plain``.
  ``run_fused_train.launches`` counts kernel launches.

Batch order comes from the caller as ``epoch_perms``, an ``(epochs, n)``
integer array of per-epoch row permutations; the final partial batch is
padded with row 0 and masked by position.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..utils.spans import span
from .chain_kernels import (
    ACT_CODES,
    MAX_SHARED_BYTES,
    _act,
    _float_bits,
    _net_slices,
    coupling_param_count,
)

__all__ = [
    "TRAIN_ACTS", "train_op_param_count", "folded_batch_grads",
    "fused_train_plain", "PackedTrainPlan", "pack_train_plan",
    "packed_batch_grads", "packed_train_reference", "run_fused_train",
    "run_fused_train_members", "pad_epoch_perms", "run_phase_names", "run_layout", "MAX_SHARED_BYTES",
]

TRAIN_ACTS = ("relu", "tanh", "sigmoid", "identity")
_LOG_2PI = float(np.log(2.0 * np.pi))


# -- plan bookkeeping ------------------------------------------------------------

def train_op_param_count(op) -> int:
    """Trainable folded tensors an op consumes."""
    tag = op[0]
    if tag == "coupling":
        return coupling_param_count(op)
    if tag == "anorm":
        return 2
    if tag == "affine":
        return 0
    raise ValueError(f"fused train does not support op {tag!r}")


def _group(plan, tparams, cparams):
    """Per-op (trainable tensors, constants)."""
    t_groups, c_groups, ti, ci = [], [], 0, 0
    for op in plan:
        cnt = train_op_param_count(op)
        t_groups.append(list(tparams[ti:ti + cnt]))
        ti += cnt
        if op[0] == "affine":
            c_groups.append(list(cparams[ci:ci + 3]))
            ci += 3
        else:
            c_groups.append([])
    if ti != len(tparams) or ci != len(cparams):
        raise ValueError(
            f"plan consumes {ti} trainable and {ci} constant tensors, got "
            f"{len(tparams)} and {len(cparams)}")
    return t_groups, c_groups


# -- plain version: per-op forward (with caches) and backward ------------------

def _dact_from_value(name, a, delta):
    """delta · σ'(u) from the activation VALUE a = σ(u)."""
    if name == "identity":
        return delta
    if name == "relu":
        return delta * (a > 0.0).to(delta.dtype)
    if name == "tanh":
        return delta * (1.0 - a * a)
    if name == "sigmoid":
        return delta * (a * (1.0 - a))
    raise ValueError(f"unsupported activation for fused train: {name}")


def _first_u(x, th, ws, has_th, has_id):
    i, u = 0, None
    if has_th:
        u = th @ ws[0]
        i = 1
    if has_id:
        ux = x @ ws[i]
        u = ux if u is None else u + ux
        i += 1
    return u, i


def _mlp_fwd(x, th, ws, bs, act, n_layers, has_th, has_id):
    """Folded conditioner forward; returns (out, the n_layers − 1 hidden
    activation values the backward needs)."""
    u, i = _first_u(x, th, ws, has_th, has_id)
    if bs[0] is not None:
        u = u + bs[0]
    a = _act(act, u)
    acts, out = [a], None
    for layer in range(1, n_layers):
        u = a @ ws[i]
        i += 1
        if bs[layer] is not None:
            u = u + bs[layer]
        if layer < n_layers - 1:
            a = _act(act, u)
            acts.append(a)
        else:
            out = u
    return out, acts


def _first_layer_bwd(delta, x, th, ws, has_th, has_id, wgrads):
    i, xbar = 0, None
    if has_th:
        wgrads[0] = th.T @ delta
        i = 1
    if has_id:
        wgrads[i] = x.T @ delta
        xbar = delta @ ws[i].T
    return xbar


def _mlp_bwd(delta_out, x, th, acts, ws, act, n_layers, has_th, has_id,
             has_bias):
    """Backward of ``_mlp_fwd``: (weight grads, bias grads, x̄) in fold
    order."""
    fb = int(has_th) + int(has_id)
    wgrads = [None] * (fb + n_layers - 1)
    bgrads = [None] * n_layers if has_bias else []
    delta = delta_out
    for layer in range(n_layers, 1, -1):
        w_idx = fb + layer - 2
        a_prev = acts[layer - 2]
        wgrads[w_idx] = a_prev.T @ delta
        if has_bias:
            bgrads[layer - 1] = delta.sum(0, keepdim=True)
        delta = _dact_from_value(act, a_prev, delta @ ws[w_idx].T)
    xbar = _first_layer_bwd(delta, x, th, ws, has_th, has_id, wgrads)
    if has_bias:
        bgrads[0] = delta.sum(0, keepdim=True)
    return wgrads, bgrads, xbar


def _clamp_s(s_full, clamp):
    """s_c = M·tanh(s/M) and dŝ/ds = 1 − (s_c/M)², a function of the clamped
    value."""
    if not clamp:
        return s_full, None
    s_c = clamp * torch.tanh(s_full / clamp)
    return s_c, 1.0 - (s_c / clamp) ** 2


def _coupling_fwd(op, prefs, x, th, ldj, want_cache):
    """Inverse-direction coupling: z = (x − t)·exp(−s), ldj −= Σs; s and t
    are d-wide and exactly zero on identity dims."""
    (_, kind, _, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th, has_id,
     clamp) = op
    fb = int(has_th) + int(has_id)
    if kind == "joint":
        n_w = fb + (n_s - 2) + 2
        ws = prefs[:n_w]
        bs = prefs[n_w:] if bias_s else [None] * (n_s + 1)
        u, i = _first_u(x, th, ws, has_th, has_id)
        if bias_s:
            u = u + bs[0]
        a = _act(act_s, u)
        acts = [a]
        for layer in range(1, n_s - 1):
            u = a @ ws[i]
            i += 1
            if bias_s:
                u = u + bs[layer]
            a = _act(act_s, u)
            acts.append(a)
        s_full = a @ ws[i]
        t_full = a @ ws[i + 1]
        if bias_s:
            s_full = s_full + bs[n_s - 1]
            t_full = t_full + bs[n_s]
        s_full, dcl = _clamp_s(s_full, clamp)
        e = torch.exp(-s_full)
        z = (x - t_full) * e
        ldj = ldj - s_full.sum(-1, keepdim=True)
        return z, ldj, ((x, ws, acts, t_full, e, dcl) if want_cache else None)

    k = 0
    if kind == "nvp":
        ws_s, bs_s, k = _net_slices(prefs, k, n_s, bias_s, has_th, has_id)
        s_full, acts_s = _mlp_fwd(x, th, ws_s, bs_s, act_s, n_s, has_th,
                                  has_id)
    ws_t, bs_t, k = _net_slices(prefs, k, n_t, bias_t, has_th, has_id)
    t_full, acts_t = _mlp_fwd(x, th, ws_t, bs_t, act_t, n_t, has_th, has_id)
    if kind == "nvp":
        s_full, dcl = _clamp_s(s_full, clamp)
        e = torch.exp(-s_full)
        z = (x - t_full) * e
        ldj = ldj - s_full.sum(-1, keepdim=True)
        cache = ((x, ws_s, acts_s, ws_t, acts_t, t_full, e, dcl)
                 if want_cache else None)
    else:  # NICE: volume preserving
        z = x - t_full
        cache = (x, ws_t, acts_t) if want_cache else None
    return z, ldj, cache


def _coupling_bwd(op, cache, th, gz, jbar):
    """Cotangents of the inverse coupling on the folded d-wide layout; note
    the −j̄ coupling of the ldj cotangent into s̄. Returns (gx, grads aligned
    with the op's folded tensors)."""
    (_, kind, _, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th, has_id,
     _clamp) = op
    if kind == "joint":
        x, ws, acts, t_full, e, dcl = cache
        fb = int(has_th) + int(has_id)
        sbar = -gz * ((x - t_full) * e) - jbar
        if dcl is not None:
            sbar = sbar * dcl  # through the tanh clamp
        tbar = -gz * e
        a_top = acts[-1]
        i_head = fb + (n_s - 2)
        wgrads = [None] * i_head + [a_top.T @ sbar, a_top.T @ tbar]
        bgrads = ([None] * (n_s - 1) + [sbar.sum(0, keepdim=True),
                                        tbar.sum(0, keepdim=True)]
                  if bias_s else [])
        delta = sbar @ ws[i_head].T + tbar @ ws[i_head + 1].T
        delta = _dact_from_value(act_s, a_top, delta)
        for layer in range(n_s - 1, 1, -1):
            w_idx = fb + layer - 2
            a_prev = acts[layer - 2]
            wgrads[w_idx] = a_prev.T @ delta
            if bias_s:
                bgrads[layer - 1] = delta.sum(0, keepdim=True)
            delta = _dact_from_value(act_s, a_prev, delta @ ws[w_idx].T)
        xbar = _first_layer_bwd(delta, x, th, ws, has_th, has_id, wgrads)
        if bias_s:
            bgrads[0] = delta.sum(0, keepdim=True)
        gx = gz * e
        if xbar is not None:
            gx = gx + xbar
        return gx, wgrads + bgrads

    if kind == "nvp":
        x, ws_s, acts_s, ws_t, acts_t, t_full, e, dcl = cache
        sbar = -gz * ((x - t_full) * e) - jbar
        if dcl is not None:
            sbar = sbar * dcl
        tbar = -gz * e
        wg_s, bg_s, xb_s = _mlp_bwd(sbar, x, th, acts_s, ws_s, act_s, n_s,
                                    has_th, has_id, bias_s)
        wg_t, bg_t, xb_t = _mlp_bwd(tbar, x, th, acts_t, ws_t, act_t, n_t,
                                    has_th, has_id, bias_t)
        gx = gz * e
        if xb_s is not None:
            gx = gx + xb_s
        if xb_t is not None:
            gx = gx + xb_t
        return gx, wg_s + bg_s + wg_t + bg_t

    x, ws_t, acts_t = cache  # nice
    wg_t, bg_t, xb_t = _mlp_bwd(-gz, x, th, acts_t, ws_t, act_t, n_t, has_th,
                                has_id, bias_t)
    return (gz if xb_t is None else gz + xb_t), wg_t + bg_t


def _plan_fwd(plan, t_groups, c_groups, x, th, want_cache):
    ldj = x.new_zeros(x.shape[0], 1)
    caches = []
    for op, tp, cp in zip(plan, t_groups, c_groups):
        if op[0] == "coupling":
            x, ldj, cache = _coupling_fwd(op, tp, x, th, ldj, want_cache)
            caches.append(cache)
        elif op[0] == "anorm":
            e = torch.exp(tp[0])
            x = (x - tp[1]) * e
            ldj = ldj + tp[0].sum()
            caches.append((x, e) if want_cache else None)
        else:  # affine
            x = x * cp[0] + cp[1]
            ldj = ldj + cp[2]
            caches.append((cp[0],) if want_cache else None)
    return x, ldj, caches


def _log_prob(z, ldj):
    d = z.shape[-1]
    return -0.5 * (z * z).sum(-1, keepdim=True) - 0.5 * d * _LOG_2PI + ldj


def _nll_and_gz(z, ldj, mask):
    """Masked NLL −Σ mᵢ·lpᵢ / max(Σm, 1e-12) and its cotangents
    (loss, gz = ∂L/∂z, jbar = ∂L/∂lp). ``mask``: (B, 1)."""
    lp = _log_prob(z, ldj)
    denom = torch.clamp(mask.sum(), min=1e-12)
    loss = -(lp * mask).sum() / denom
    jbar = -mask / denom
    return loss, -jbar * z, jbar


def _plan_bwd(plan, t_groups, caches, th, gz, jbar):
    grads = [None] * len(plan)
    for i in range(len(plan) - 1, -1, -1):
        op = plan[i]
        if op[0] == "coupling":
            gz, grads[i] = _coupling_bwd(op, caches[i], th, gz, jbar)
        elif op[0] == "anorm":
            # z = (x − b)·eˢ: ∂z/∂s = z, ∂z/∂b = −eˢ; the ldj term Σⱼsⱼ
            # couples Σ jbar into every sⱼ
            z_val, e = caches[i]
            grads[i] = [(gz * z_val).sum(0, keepdim=True) + jbar.sum(),
                        -gz.sum(0, keepdim=True) * e]
            gz = gz * e
        else:
            grads[i] = []
            gz = gz * caches[i][0]
    return [g for group in grads for g in group]


def folded_batch_grads(plan, tparams, cparams, x, theta, mask):
    """Loss and hand-derived gradients of one batch with respect to the
    folded tensors (before the 0/1 masks). ``mask``: (B,) row weights."""
    th = theta if theta is not None and theta.shape[-1] else None
    t_groups, c_groups = _group(plan, tparams, cparams)
    z, ldj, caches = _plan_fwd(plan, t_groups, c_groups, x, th, True)
    loss, gz, jbar = _nll_and_gz(z, ldj, mask.reshape(-1, 1))
    return loss, _plan_bwd(plan, t_groups, caches, th, gz, jbar)


def _folded_log_prob(plan, tparams, cparams, x, theta):
    th = theta if theta is not None and theta.shape[-1] else None
    t_groups, c_groups = _group(plan, tparams, cparams)
    z, ldj, _ = _plan_fwd(plan, t_groups, c_groups, x, th, False)
    return _log_prob(z, ldj)[:, 0]


# -- the run, shared by the plain version and the packed reference -----------

def pad_epoch_perms(epoch_perms, n: int, batchsize: int) -> np.ndarray:
    """``(epochs, n)`` permutations → ``(epochs, n_pad)`` int32 gather
    indices, the pad entries pointing at row 0 (masked by position)."""
    perms = np.asarray(epoch_perms)
    if perms.ndim != 2 or perms.shape[1] != n:
        raise ValueError(
            f"epoch_perms must have shape (epochs, {n}), got {perms.shape}")
    if perms.size and (perms.min() < 0 or perms.max() >= n):
        raise ValueError("epoch_perms holds a row index out of range")
    n_pad = -(-n // batchsize) * batchsize
    idx = np.zeros((perms.shape[0], n_pad), np.int32)
    idx[:, :n] = perms
    return idx


def _adam_scalars(lr, b1, b2, eps):
    """The hyperparameters as the float32 values the kernel is given."""
    f = np.float32
    return dict(lr=f(lr), b1=f(b1), b2=f(b2), eps=f(eps), omb1=f(1.0 - b1),
                omb2=f(1.0 - b2), logb1=f(np.log(b1)), logb2=f(np.log(b2)))


def _adam_step(params, mu, nu, grads, t, hp):
    """One ``optax.adam`` update at step ``t`` of the lists, in place: the
    bias corrections as the kernels write them, ``1 − exp(t·log b)`` in
    f32. ``hp``: :func:`_adam_scalars` as floats."""
    t = np.float32(t)
    bc1 = float(np.float32(1.0) - np.exp(t * np.float32(hp["logb1"])))
    bc2 = float(np.float32(1.0) - np.exp(t * np.float32(hp["logb2"])))
    for k, g in enumerate(grads):
        mu[k] = hp["b1"] * mu[k] + hp["omb1"] * g
        nu[k] = hp["b2"] * nu[k] + hp["omb2"] * g * g
        params[k] = params[k] - hp["lr"] * (mu[k] / bc1) / (
            torch.sqrt(nu[k] / bc2) + hp["eps"])


def _eval_nll(lp, w, n_rows):
    """Unweighted: −Σlp / rows; weighted: −Σw·lp / max(Σw, 1e-12)."""
    if w is None:
        return float(-lp.sum() / np.float32(n_rows))
    return float(-(lp * w).sum() / torch.clamp(w.sum(), min=1e-12))


def _train_loop(grads_fn, lp_fn, params, mu, nu, masks, x, theta, x_valid,
                theta_valid, idx, *, batchsize, count0, hp, track_best, w,
                w_valid, guard):
    """The run on a list of parameter tensors. ``grads_fn(params, xb, thb,
    m) → (loss, grads)``; ``lp_fn(params, x, theta) → (rows,)`` log-probs."""
    n = x.shape[0]
    epochs = idx.shape[0]
    n_batches = idx.shape[1] // batchsize
    idx_t = torch.as_tensor(idx, device=x.device).long()
    pos_mask = (torch.arange(idx.shape[1], device=x.device) < n).to(x.dtype)
    params = [p.clone() for p in params]
    mu = [m.clone() for m in mu]
    nu = [v.clone() for v in nu]
    hp = {k: float(v) for k, v in hp.items()}
    tls, vls, skips, best = [], [], [], None
    prev_best = math.inf
    applied = 0
    for e in range(epochs):
        e_skips = 0
        for b in range(n_batches):
            sl = slice(b * batchsize, (b + 1) * batchsize)
            rows = idx_t[e, sl]
            m = pos_mask[sl]
            if w is not None:
                m = m * w[rows]
            loss, grads = grads_fn(params, x[rows],
                                   theta[rows] if theta is not None else None,
                                   m)
            grads = [g if mk is None else
                     torch.where(mk > 0.5, g, torch.zeros_like(g))
                     for g, mk in zip(grads, masks)]
            if guard:
                ok = bool(torch.isfinite(loss)) and all(
                    bool(torch.isfinite(g).all()) for g in grads)
                if not ok:
                    e_skips += 1
                    continue
            # the Adam step is count0 + APPLIED updates + 1
            _adam_step(params, mu, nu, grads, count0 + applied + 1, hp)
            applied += 1
        tl = _eval_nll(lp_fn(params, x, theta), w, n)
        vl = _eval_nll(lp_fn(params, x_valid, theta_valid), w_valid,
                       x_valid.shape[0])
        if track_best:
            # epoch 0 writes unconditionally; `<` is false on NaN, and a NaN
            # in the history keeps every later epoch from winning
            if e == 0 or vl < prev_best:
                best = [p.clone() for p in params]
            prev_best = (math.nan if math.isnan(vl) or math.isnan(prev_best)
                         else min(prev_best, vl))
        tls.append(tl)
        vls.append(vl)
        skips.append(e_skips)
    f32 = dict(dtype=torch.float32, device=x.device)
    return (params, mu, nu, torch.tensor(tls, **f32), torch.tensor(vls, **f32),
            best, torch.tensor(skips, dtype=torch.int32, device=x.device)
            if guard else None)


def _dense_masks(n_params, masks, mask_slots):
    return [None if mask_slots[k] is None else masks[mask_slots[k]]
            for k in range(n_params)]


def fused_train_plain(plan, tparams, masks, mask_slots, cparams, mu, nu, x,
                      theta, x_valid, theta_valid, epoch_perms, *, batchsize,
                      count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                      track_best=False, w=None, w_valid=None,
                      guard_nonfinite=False):
    """Plain PyTorch version of ``train_run``; same arguments and results as
    :func:`run_fused_train`. Float32 products run in full f32 (TF32 is
    switched off for the duration of the call)."""
    idx = pad_epoch_perms(epoch_perms, x.shape[0], batchsize)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _train_loop(
                lambda ps, xb, thb, m: folded_batch_grads(plan, ps, cparams,
                                                          xb, thb, m),
                lambda ps, xx, tt: _folded_log_prob(plan, ps, cparams, xx, tt),
                tparams, mu, nu,
                _dense_masks(len(tparams), masks, mask_slots), x, theta,
                x_valid, theta_valid, idx, batchsize=batchsize,
                count0=count0, hp=_adam_scalars(lr, b1, b2, eps),
                track_best=track_best, w=w, w_valid=w_valid,
                guard=guard_nonfinite)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# -- lowering a plan to the kernel's program ----------------------------------

# instruction opcodes of csrc/train_kernels.cu; every instruction is
# _INSTR_WORDS int32 words, word 0 the opcode
(_F_DENSE, _F_COUPLE, _F_ANORM, _F_AFFINE,
 _B_COUPLE, _B_DENSE, _B_ANORM, _B_AFFINE) = range(8)
_INSTR_WORDS = 16
# words of an instruction that train_run's phases read (the step kernels'
# lowering leaves them 0): the phase's items before this instruction's, and
# 1 where the instruction runs in the same phase as the one before it
_W_START, _W_JOIN = 14, 15
_KIND_NVP, _KIND_NICE = 0, 1
# header words at the start of the program buffer
(_H_NP, _H_NC, _H_B, _H_D, _H_N, _H_P, _H_MU, _H_NU, _H_G, _H_C, _H_TH,
 _H_X0, _H_Z, _H_GZ, _H_LDJ, _H_MASK, _H_JBAR, _H_LP, _H_SCAL, _H_NFWD,
 _H_NBWD, _H_TOTAL) = range(22)
# train_run's words: where the program is staged in shared memory (-1: read
# from device memory), the rows of an evaluation tile, the partial sums over
# rows (their count and where they lie); in the evaluation program's header
# the per-row products lp·m and masks and the accumulators of both splits
_H_PROG_S, _H_EVAL_ROWS, _H_PARTS, _H_PART = 22, 23, 24, 25
# ... and the gradient's copies: how many segments of the batch's rows a
# weight or bias gradient is summed in (1: one), where the copies of the
# gradient buffer for segments 1 .. lie
_H_GSEGS, _H_GCOPY = 26, 27
_E_LPM, _E_MW, _E_PARTS, _E_ACC = 22, 23, 24, 25
_HEADER_WORDS = 32
_SCALAR_FLOATS = 8     # loss, denominator, ok flag, 2 x (eval sum, weight sum)
# train_run reads only the ok flag (word 2) of the scalars: where a batch's
# partial sums over rows number at most two, they lie in words 3 to 6
_SCAL_PART, _SCAL_MAX_PARTS = 3, 2


def _parts(rows: int) -> int:
    """Partial sums a reduction over ``rows`` rows is cut into (each over
    consecutive rows, added in index order): about sqrt(rows), at most 32."""
    return max(1, min(32, math.isqrt(max(rows - 1, 0)) + 1))


@dataclasses.dataclass
class PackedTrainPlan:
    """A training plan lowered for ``train_run``.

    ``prog``: int32 buffer ``[header | forward program | backward program]``.
    The block's shared memory is one float array; the header and the
    instructions hold offsets into it. Parameters, both Adam moments and the
    gradients are flat buffers of ``n_params`` floats in the order of the
    folded tensors (row-major, no padding); ``flat_mask`` is the 0/1 select
    mask in the same order (1 where a tensor has no mask) and ``flat_consts``
    the Normalization constants. Offsets of weights and biases in the
    instructions are relative to the start of the parameter buffer.

    The resident layout (``train_run``'s) also has ``eval_prog``, ``[header
    | forward program]`` lowered for evaluation tiles of ``eval_rows`` rows
    whose buffers reuse the batch caches' floats; ``paired``: the s- and
    t-nets' backward steps share phases (each net has its own scratch);
    ``staged``: both programs are copied into the block's shared memory;
    ``grad_segments``: the weight and bias gradients are summed over that
    many segments of the batch's rows into copies of the gradient buffer,
    added in order by the mask phase."""

    plan: tuple
    d: int
    n: int
    batchsize: int
    shapes: list          # shape of each folded tensor
    offsets: list         # its offset in the flat parameter buffer
    n_params: int
    hmax: int             # widest dense output
    prog: torch.Tensor
    flat_mask: torch.Tensor
    flat_consts: torch.Tensor
    header: dict
    n_fwd: int
    n_bwd: int
    total_floats: int
    cache_floats: int     # activation caches and scratch of one batch
    eval_prog: torch.Tensor | None = None
    eval_header: dict | None = None
    eval_rows: int = 0
    n_eval: int = 0
    paired: bool = False
    staged: bool = False
    grad_segments: int = 1

    @property
    def shared_bytes(self) -> int:
        return 4 * self.total_floats

    def flatten(self, tensors) -> torch.Tensor:
        if len(tensors) != len(self.shapes):
            raise ValueError(f"expected {len(self.shapes)} folded tensors, "
                             f"got {len(tensors)}")
        for t, shape in zip(tensors, self.shapes):
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"folded tensor of shape {tuple(t.shape)}, "
                                 f"expected {tuple(shape)}")
        return torch.cat([t.reshape(-1) for t in tensors]).contiguous()

    def unflatten(self, flat) -> list:
        return [flat[o:o + int(np.prod(s))].reshape(s).clone()
                for o, s in zip(self.offsets, self.shapes)]


class _Dense:
    """One dense layer of a lowered net: its input blocks ``(offset of the
    input rows, K, index of the weight tensor)`` — two for a first layer
    with a θ and an x block — its output width, the index of its bias tensor
    (or None) and the offset of its output rows."""

    def __init__(self, blocks, width, bias_k, out):
        self.blocks, self.width, self.bias_k, self.out = \
            blocks, width, bias_k, out


class _TrainPacker:
    """Hands out the block's floats and collects the instructions.

    ``evaluation``: the forward program alone, for tiles whose buffers are
    reused (hidden layers ping-pong per net, the coupling caches into one
    discarded buffer); no backward is emitted. ``paired``: the nets of a
    coupling run side by side (their layers in shared phases), each with its
    own pair of backward scratch buffers. ``keep_deltas``: every backward
    cotangent a dense layer reads (its delta) gets rows of its own, and so
    does every coupling's s / t pair, so that all of them still hold their
    values when the backward has ended (the layout of train_stream's
    tensor-core design, whose weight gradients are summed over the batch
    after the backward)."""

    def __init__(self, d, n, batchsize, shapes, offs, *, evaluation=False,
                 paired=False, keep_deltas=False):
        self.d, self.n, self.bsz = d, n, batchsize
        self.shapes, self.offs = shapes, offs
        self.evaluation, self.paired = evaluation, paired
        self.keep_deltas = keep_deltas
        self.top = 0          # floats of shared memory handed out
        self.fwd = []
        self.bwd_groups = []  # per op; emitted in reverse op order
        self.th_off = -1
        self.scratch = (-1, -1)
        self.net_scratch = None   # paired: ((s0, s1), (t0, t1))
        self.hidden_bufs = None   # evaluation: per net, two buffers
        self.discard = -1         # evaluation: the caches' buffer

    def alloc(self, floats: int) -> int:
        off = self.top
        self.top += int(floats)
        return off

    def rows(self, width: int) -> int:
        return self.alloc(self.bsz * width)

    def hidden(self, net: int, layer: int, width: int) -> int:
        """Where layer ``layer`` of net ``net`` leaves its activations: its
        own cache, or (evaluation) the net's ping-pong buffer."""
        if self.evaluation:
            return self.hidden_bufs[net][layer % 2]
        return self.rows(width)

    def delta(self, width: int, slot: int) -> int:
        """Rows for a hidden cotangent of ``width`` columns: scratch buffer
        ``slot``, or rows of its own where the deltas are kept."""
        return self.rows(width) if self.keep_deltas else self.scratch[slot]

    def cache(self) -> int:
        """A coupling's d-wide cache (e or the clamped s)."""
        return self.discard if self.evaluation else self.rows(self.d)

    @staticmethod
    def instr(*words):
        words = [int(w) for w in words]
        if len(words) > _W_START:
            raise AssertionError("instruction too long")
        return words + [0] * (_INSTR_WORDS - len(words))

    def _off(self, k):
        return self.offs[k] if k is not None else -1

    def dense_fwd(self, layer: _Dense, act: str):
        b1 = layer.blocks[0]
        b2 = layer.blocks[1] if len(layer.blocks) > 1 else (-1, 0, None)
        self.fwd.append(self.instr(
            _F_DENSE, b1[0], b1[1], self._off(b1[2]), b2[0], b2[1],
            self._off(b2[2]), layer.width, self._off(layer.bias_k),
            ACT_CODES[act], layer.out))

    def dense_bwd(self, block, width, delta, bias_k, dout, acc, dact: str):
        """Weight gradient of one input block, the bias gradient when
        ``bias_k`` is given, and — when ``dout`` ≥ 0 — the input cotangent
        ``(delta @ Wᵀ [+ what dout holds]) · dact(input values)``."""
        if self.evaluation:
            return
        src, k, wi = block
        self.bwd_groups[-1].append(self.instr(
            _B_DENSE, src, k, self._off(wi), width, delta, self._off(bias_k),
            dout, acc, ACT_CODES[dact]))

    def stack_fwd(self, k0, n_stack, bias_k, act, has_th, has_id, x_in,
                  net=0):
        """The first ``n_stack`` dense layers of a net, each followed by the
        activation. ``k0``: index of the net's first folded tensor;
        ``bias_k``: index of its first bias tensor or None. Returns the
        layers and the index of the next weight tensor."""
        i = k0
        blocks = []
        if has_th:
            blocks.append((self.th_off, self.n, i))
            i += 1
        if has_id:
            blocks.append((x_in, self.d, i))
            i += 1
        layers = []
        for layer in range(n_stack):
            if layer:
                blocks = [(layers[-1].out, layers[-1].width, i)]
                i += 1
            width = self.shapes[blocks[0][2]][1]
            dense = _Dense(blocks, width,
                           bias_k + layer if bias_k is not None else None,
                           self.hidden(net, layer, width))
            self.dense_fwd(dense, act)
            layers.append(dense)
        return layers, i

    def net_bwd(self, layers, act, delta, gz, flip=0, scratch=None):
        """Backward of the dense layers ``layers`` (forward order) whose last
        output cotangent lies at ``delta``. Hidden cotangents alternate
        between the two scratch buffers, starting with ``scratch[flip]``
        (which must not be ``delta``); the first layer's x block accumulates
        into the x cotangent ``gz`` and its θ block has no input
        cotangent. Returns the instructions' step lengths: one step per
        layer, the first layer's blocks one step."""
        scratch = scratch or self.scratch
        steps = []
        for dense in reversed(layers[1:]):
            dout = (self.rows(dense.blocks[0][1]) if self.keep_deltas
                    else scratch[flip])
            flip ^= 1
            self.dense_bwd(dense.blocks[0], dense.width, delta, dense.bias_k,
                           dout, 0, act)
            steps.append(1)
            delta = dout
        first = layers[0]
        for j, block in enumerate(first.blocks):
            is_x = block[0] != self.th_off
            self.dense_bwd(
                block, first.width, delta,
                first.bias_k if j == len(first.blocks) - 1 else None,
                gz if is_x else -1, 1 if is_x else 0, "identity")
        steps.append(len(first.blocks))
        return steps


def _interleave(lists):
    """The forward instructions of the nets of a coupling, layer by layer
    across the nets, each layer's instructions one phase."""
    out = []
    for j in range(max(len(x) for x in lists)):
        group = [x[j] for x in lists if j < len(x)]
        for k, ins in enumerate(group):
            ins[_W_JOIN] = 1 if k else 0
        out += group
    return out


def _pair_backward(nets):
    """The backward steps of a coupling's nets side by side: step j of each
    net in one phase, except that two instructions adding into the x
    cotangent (the first layers' x blocks) never share one. ``nets``: per
    net its instructions and step lengths."""
    per_net = []
    for instrs, steps in nets:
        cut, k = [], 0
        for n_ins in steps:
            cut.append(instrs[k:k + n_ins])
            k += n_ins
        per_net.append(cut)
    out = []
    for j in range(max(len(c) for c in per_net)):
        group, late = [], []
        for cut in per_net:
            if j >= len(cut):
                continue
            for ins in cut[j]:
                adds_gz = ins[0] == _B_DENSE and ins[8] == 1
                if adds_gz and any(g[0] == _B_DENSE and g[8] == 1
                                   for g in group):
                    late.append(ins)
                else:
                    group.append(ins)
        for phase in (group, late):
            for k, ins in enumerate(phase):
                ins[_W_JOIN] = 1 if k else 0
            out += phase
    return out


def _lower_coupling(pk, op, ti, x_in, x_out, s_buf, t_buf, gz):
    (_, kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th, has_id,
     clamp) = op
    if dirn != "inv":
        raise ValueError("training folds the inverse direction only")
    if not (has_th or has_id):
        raise ValueError("coupling op without conditioner input")
    if kind not in ("nvp", "nice", "joint"):
        raise ValueError(f"unknown coupling kind {kind!r}")
    fb = int(has_th) + int(has_id)
    e_buf, sc_buf = pk.cache(), pk.cache()
    knd = _KIND_NICE if kind == "nice" else _KIND_NVP
    cbits = _float_bits(clamp)
    if not pk.evaluation:
        pk.bwd_groups[-1].append(pk.instr(
            _B_COUPLE, knd, gz, x_out, e_buf, sc_buf, s_buf, t_buf, cbits))
    if kind == "joint":
        if act_s not in TRAIN_ACTS:
            raise ValueError(f"unsupported activation for fused train: {act_s}")
        if n_s < 2:
            raise ValueError("a joint conditioner needs at least 2 layers")
        bias_k = ti + fb + n_s if bias_s else None
        stack, i = pk.stack_fwd(ti, n_s - 1, bias_k, act_s, has_th, has_id,
                                x_in)
        top = stack[-1]
        heads = []
        for head, dst in ((0, s_buf), (1, t_buf)):
            dense = _Dense(
                [(top.out, top.width, i + head)], pk.d,
                bias_k + n_s - 1 + head if bias_s else None, dst)
            pk.dense_fwd(dense, "identity")
            heads.append(dense)
        # the two heads leave the cotangent of the shared stack's output in
        # scratch[0]: s̄·Wsᵀ, then + t̄·Wtᵀ, then the activation derivative
        top_bar = pk.delta(top.width, 0)
        pk.dense_bwd(heads[0].blocks[0], pk.d, s_buf, heads[0].bias_k,
                     top_bar, 0, "identity")
        pk.dense_bwd(heads[1].blocks[0], pk.d, t_buf, heads[1].bias_k,
                     top_bar, 1, act_s)
        pk.net_bwd(stack, act_s, top_bar, gz, flip=1)
    else:
        k0 = 0 + ti
        fwd, bwd = [], []
        for net, (is_s, n_l, act, has_b, dst) in enumerate(
                ((True, n_s, act_s, bias_s, s_buf),
                 (False, n_t, act_t, bias_t, t_buf))):
            if is_s and kind != "nvp":
                continue
            if act not in TRAIN_ACTS:
                raise ValueError(
                    f"unsupported activation for fused train: {act}")
            if n_l < 2:
                raise ValueError(
                    "a folded conditioner needs at least 2 layers")
            n_w = fb + n_l - 1
            bias_k = k0 + n_w if has_b else None
            f0 = len(pk.fwd)
            layers, i = pk.stack_fwd(k0, n_l - 1, bias_k, act, has_th, has_id,
                                     x_in, net=net)
            final = _Dense([(layers[-1].out, layers[-1].width, i)], pk.d,
                           bias_k + n_l - 1 if has_b else None, dst)
            pk.dense_fwd(final, "identity")
            fwd.append(pk.fwd[f0:])
            del pk.fwd[f0:]
            if not pk.evaluation:
                b0 = len(pk.bwd_groups[-1])
                steps = pk.net_bwd(
                    layers + [final], act, dst, gz,
                    scratch=pk.net_scratch[net] if pk.paired else None)
                bwd.append((pk.bwd_groups[-1][b0:], steps))
                del pk.bwd_groups[-1][b0:]
            k0 += n_w + (n_l if has_b else 0)
        if pk.paired or pk.evaluation:
            pk.fwd += _interleave(fwd)
        else:
            pk.fwd += [ins for net in fwd for ins in net]
        if not pk.evaluation:
            if pk.paired:
                pk.bwd_groups[-1] += _pair_backward(bwd)
            else:
                pk.bwd_groups[-1] += [ins for net in bwd for ins in net[0]]
    pk.fwd.append(pk.instr(_F_COUPLE, knd, x_in, x_out, s_buf, t_buf, e_buf,
                           sc_buf, cbits))


def _items(ins, bsz, d, segs=1):
    """Work items of an instruction: the loop bound of its handler in
    train_run (f_dense4 / b_dense4 of csrc/train_kernels.cu, their weight
    and bias gradients in ``segs`` row segments; the others are
    csrc/flow_phases.cuh's)."""
    op = ins[0]
    groups = -(-bsz // 4)
    if op == _F_DENSE:
        return groups * ins[7]
    if op in (_F_COUPLE, _F_ANORM, _F_AFFINE):
        return bsz
    if op in (_B_COUPLE, _B_AFFINE):
        return bsz * d
    if op == _B_DENSE:
        k, n = ins[2], ins[4]
        return segs * (k * -(-n // 4) + (n if ins[6] >= 0 else 0)) + (
            groups * k if ins[7] >= 0 else 0)
    if op == _B_ANORM:
        return d
    raise ValueError(f"opcode {op}")


def _phase_starts(instrs, bsz, d, segs=1):
    """Word _W_START of each instruction: the items of the instructions
    before it in its phase, so that the phase's threads take the items of
    all its instructions in one round."""
    start = 0
    for ins in instrs:
        if not ins[_W_JOIN]:
            start = 0
        ins[_W_START] = start
        start += _items(ins, bsz, d, segs=segs)


def _lower_ops(pk, plan, d, x_in, s_buf, t_buf, gz, x_outs):
    """Every op of ``plan`` in order; ``x_outs(i)`` gives the buffer op ``i``
    writes its output rows to. Returns the final rows' offset and the
    constants consumed."""
    ti = c0 = 0
    offs = pk.offs
    for k, op in enumerate(plan):
        tag = op[0]
        x_out = x_outs(k)
        pk.bwd_groups.append([])
        if tag == "coupling":
            if pk.keep_deltas:
                s_buf, t_buf = pk.rows(d), pk.rows(d)
            _lower_coupling(pk, op, ti, x_in, x_out, s_buf, t_buf, gz)
        elif tag == "anorm":
            pk.fwd.append(pk.instr(_F_ANORM, x_in, x_out, offs[ti],
                                   offs[ti + 1]))
            pk.bwd_groups[-1].append(pk.instr(_B_ANORM, gz, x_out, offs[ti],
                                              offs[ti + 1]))
        elif tag == "affine":
            pk.fwd.append(pk.instr(_F_AFFINE, x_in, x_out, c0, c0 + d,
                                   c0 + 2 * d))
            pk.bwd_groups[-1].append(pk.instr(_B_AFFINE, gz, c0))
            c0 += 2 * d + 1
        ti += train_op_param_count(op)
        x_in = x_out
    return x_in, ti, c0


def _header(values) -> list:
    header = [0] * _HEADER_WORDS
    for word, val in values:
        header[word] = int(val)
    return header


def _eval_layout(plan, shapes, offs, d, n, rows, base):
    """The evaluation program for tiles of ``rows`` rows, its buffers from
    float ``base`` on: (packer, header dict, words of header + program)."""
    hmax = max([s[1] for s in shapes] + [d])
    pk = _TrainPacker(d, n, rows, shapes, offs, evaluation=True)
    pk.top = base
    hdr = {}
    pk.th_off = hdr["TH"] = pk.rows(n) if n else -1
    xs = (pk.rows(d), pk.rows(d))
    hdr["X0"] = xs[0]
    s_buf, t_buf = pk.rows(d), pk.rows(d)
    pk.discard = pk.rows(d)
    pk.hidden_bufs = [(pk.rows(hmax), pk.rows(hmax)) for _ in range(2)]
    for name in ("LDJ", "MASK", "LP", "LPM", "MW"):
        hdr[name] = pk.alloc(rows)
    parts = _parts(rows)
    hdr["ACC"] = pk.alloc(4 * parts)
    z, _, _ = _lower_ops(pk, plan, d, xs[0], s_buf, t_buf, -1,
                         lambda k: xs[(k + 1) % 2])
    hdr["Z"] = z
    _phase_starts(pk.fwd, rows, d)
    header = _header((
        (_H_B, rows), (_H_D, d), (_H_N, n), (_H_TH, hdr["TH"]),
        (_H_X0, hdr["X0"]), (_H_Z, z), (_H_GZ, -1), (_H_LDJ, hdr["LDJ"]),
        (_H_MASK, hdr["MASK"]), (_H_JBAR, -1), (_H_LP, hdr["LP"]),
        (_H_SCAL, hdr["ACC"]), (_H_NFWD, len(pk.fwd)), (_H_NBWD, 0),
        (_H_TOTAL, pk.top), (_E_LPM, hdr["LPM"]), (_E_MW, hdr["MW"]),
        (_E_PARTS, parts), (_E_ACC, hdr["ACC"])))
    return pk, hdr, header + [w for ins in pk.fwd for w in ins]


def _eval_rows(plan, shapes, offs, d, n, base, room):
    """Rows of an evaluation tile: the most whose buffers fit ``room``
    floats from ``base`` (the batch caches' floats), at least one."""
    def need(rows):
        return _eval_layout(plan, shapes, offs, d, n, rows, base)[0].top \
            - base

    lo, hi = 1, 2
    while need(hi) <= room and hi < (1 << 16):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if need(mid) <= room else (lo, mid)
    return lo


def pack_train_plan(plan, tparams, masks, mask_slots, cparams, d: int, n: int,
                    batchsize: int, *, state_in_shared: bool = True,
                    paired: bool | None = None,
                    eval_rows: int | None = None,
                    grad_segments: int | None = None,
                    keep_deltas: bool = False) -> PackedTrainPlan:
    """Lower a training plan into the kernel's forward and backward programs
    and lay out the block's shared memory for batches of ``batchsize`` rows.
    Depends on the shapes of ``tparams`` and on the values of the masks and
    constants.

    ``state_in_shared=False`` is the layout of the step kernel
    (``ops/step_kernels.py``): parameters, gradients and constants stay in
    device memory, the header names no offset for them (-1), and the shared
    array holds one tile's rows, caches and scratch only.

    The resident layout (``train_run``'s) pairs the s- and t-nets of every
    coupling (their layers share phases) and sums the weight and bias
    gradients in 4 (else 2) segments of the batch's rows where each net's
    own backward scratch and the gradient's copies still fit a block,
    lowers the evaluation program for tiles as large as the batch caches'
    floats hold, and stages both programs in shared memory where they fit.
    The last layout it tries (unpaired, one segment, at most two partial
    sums over the batch's rows, in the scalar area) needs no more floats
    than the state plus the step kernel's layout, so the envelope of
    ``_check_budget`` is that of a block holding the state and one batch.
    ``paired`` / ``grad_segments`` / ``eval_rows`` (a cap on the evaluation
    tile) hold those choices fixed: hooks for the tests and the probes that
    run the fallback layouts, never set by the library.

    ``keep_deltas`` (with ``state_in_shared=False`` only) gives every
    dense layer's output cotangent and every coupling's s / t rows of their
    own (``_TrainPacker``): the layout of one 64-row tile in the device
    workspace of train_stream's tensor-core design."""
    if not state_in_shared:
        return _pack(plan, tparams, masks, mask_slots, cparams, d, n,
                     batchsize, state_in_shared=False, paired=False,
                     keep_deltas=keep_deltas)
    if keep_deltas:
        raise ValueError("keep_deltas is a layout of the device workspace")
    kw = dict(state_in_shared=True, eval_cap=eval_rows)
    parts = _parts(batchsize)
    choices = [(pair, segs, parts) for pair in (True, False)
               for segs in (4, 2, 1)]
    choices.append((False, 1, min(parts, _SCAL_MAX_PARTS)))
    choices = [c for c in choices
               if (paired is None or c[0] == paired)
               and (grad_segments is None or c[1] == grad_segments)]
    for pair, segs, n_parts in choices:
        packed = _pack(plan, tparams, masks, mask_slots, cparams, d, n,
                       batchsize, paired=pair, segs=segs, parts=n_parts,
                       **kw)
        if packed.shared_bytes <= MAX_SHARED_BYTES:
            break
    return packed


def _pack(plan, tparams, masks, mask_slots, cparams, d, n, batchsize, *,
          state_in_shared, paired, segs=1, parts=1, eval_cap=None,
          keep_deltas=False):
    device = tparams[0].device
    shapes = [tuple(int(s) for s in p.shape) for p in tparams]
    if any(len(s) != 2 for s in shapes):
        raise ValueError("folded tensors must be 2-D")
    offs, o = [], 0
    for s in shapes:
        offs.append(o)
        o += int(np.prod(s))
    n_params = o
    hmax = max([s[1] for s in shapes] + [d])
    pk = _TrainPacker(d, n, batchsize, shapes, offs, paired=paired,
                      keep_deltas=keep_deltas)
    n_consts = sum(int(c.numel()) for c in cparams)
    if state_in_shared:
        hdr = {name: pk.alloc(n_params) for name in ("P", "MU", "NU", "G")}
        hdr["C"] = pk.alloc(n_consts)
    else:
        hdr = dict.fromkeys(("P", "MU", "NU", "G", "C"), -1)
    cache0 = pk.top
    pk.th_off = hdr["TH"] = pk.rows(n) if n else -1
    x_in = hdr["X0"] = pk.rows(d)
    # kept deltas: each coupling's s / t rows and each cotangent its own
    s_buf, t_buf = (-1, -1) if keep_deltas else (pk.rows(d), pk.rows(d))
    gz = hdr["GZ"] = pk.rows(d)
    if not keep_deltas:
        pk.scratch = (pk.rows(hmax), pk.rows(hmax))
    if paired:
        pk.net_scratch = (pk.scratch, (pk.rows(hmax), pk.rows(hmax)))
    for name in ("LDJ", "MASK", "JBAR", "LP"):
        hdr[name] = pk.alloc(batchsize)
    hdr["SCAL"] = pk.alloc(_SCALAR_FLOATS)
    if state_in_shared:
        # partial sums over the batch's rows: the mask's, then lp·m's
        hdr["PART"] = (hdr["SCAL"] + _SCAL_PART if parts <= _SCAL_MAX_PARTS
                       else pk.alloc(2 * parts))
        # the gradient's copies for row segments 1 .. segs - 1
        hdr["GCOPY"] = pk.alloc((segs - 1) * n_params)

    hdr["Z"], ti, c0 = _lower_ops(pk, plan, d, x_in, s_buf, t_buf, gz,
                                  lambda k: pk.rows(d))
    if ti != len(tparams) or c0 != n_consts:
        raise ValueError("plan does not match the folded tensors")
    bwd = [ins for group in reversed(pk.bwd_groups) for ins in group]
    if state_in_shared:
        _phase_starts(pk.fwd, batchsize, d)
        _phase_starts(bwd, batchsize, d, segs)

    total = pk.top
    eval_words, e_hdr, e_rows, n_eval = [], None, 0, 0
    prog_s = -1
    if state_in_shared:
        e_rows = _eval_rows(plan, shapes, offs, d, n, cache0, total - cache0)
        if eval_cap:
            e_rows = min(e_rows, int(eval_cap))
        epk, e_hdr, eval_words = _eval_layout(plan, shapes, offs, d, n,
                                              e_rows, cache0)
        n_eval = len(epk.fwd)
        total = max(total, epk.top)
        words = _HEADER_WORDS + (len(pk.fwd) + len(bwd)) * _INSTR_WORDS \
            + len(eval_words)
        staged_total = (total + 3) // 4 * 4 + words
        if 4 * staged_total <= MAX_SHARED_BYTES:
            prog_s = (total + 3) // 4 * 4
            total = staged_total
    header = _header((
        (_H_NP, n_params), (_H_NC, n_consts), (_H_B, batchsize),
        (_H_D, d), (_H_N, n), (_H_P, hdr["P"]), (_H_MU, hdr["MU"]),
        (_H_NU, hdr["NU"]), (_H_G, hdr["G"]), (_H_C, hdr["C"]),
        (_H_TH, hdr["TH"]), (_H_X0, hdr["X0"]), (_H_Z, hdr["Z"]),
        (_H_GZ, hdr["GZ"]), (_H_LDJ, hdr["LDJ"]), (_H_MASK, hdr["MASK"]),
        (_H_JBAR, hdr["JBAR"]), (_H_LP, hdr["LP"]),
        (_H_SCAL, hdr["SCAL"]), (_H_NFWD, len(pk.fwd)),
        (_H_NBWD, len(bwd)), (_H_TOTAL, total)))
    if state_in_shared:
        for word, val in ((_H_PROG_S, prog_s), (_H_EVAL_ROWS, e_rows),
                          (_H_PARTS, parts), (_H_PART, hdr["PART"]),
                          (_H_GSEGS, segs), (_H_GCOPY, hdr["GCOPY"])):
            header[word] = int(val)
    words = header + [w for ins in pk.fwd for w in ins] \
        + [w for ins in bwd for w in ins]
    prog = torch.tensor(words, dtype=torch.int32, device=device)
    eval_prog = (torch.tensor(eval_words, dtype=torch.int32, device=device)
                 if eval_words else None)

    flat_mask = torch.ones(n_params, dtype=torch.float32, device=device)
    for k, slot in enumerate(mask_slots):
        if slot is not None:
            flat_mask[offs[k]:offs[k] + int(np.prod(shapes[k]))] = \
                masks[slot].reshape(-1)
    flat_consts = (torch.cat([c.reshape(-1) for c in cparams])
                   if cparams else torch.zeros(0, device=device))
    return PackedTrainPlan(
        tuple(plan), d, n, batchsize, shapes, offs, n_params, hmax, prog,
        flat_mask, flat_consts.to(torch.float32).contiguous(), hdr,
        len(pk.fwd), len(bwd), total, total - cache0, eval_prog, e_hdr,
        e_rows, n_eval, paired, prog_s >= 0, segs)


# -- the lowered program, executed in PyTorch ----------------------------------

_ACT_NAMES = {v: k for k, v in ACT_CODES.items()}
_OP_NAMES = ("f_dense", "f_couple", "f_anorm", "f_affine", "b_couple",
             "b_dense", "b_anorm", "b_affine")


def _unbits(i: int) -> float:
    import struct

    return struct.unpack("<f", struct.pack("<i", int(i)))[0]


class _Machine:
    """The block's shared memory as one flat tensor, and the instruction set
    of ``csrc/train_kernels.cu`` on it, one batch of ``batchsize`` rows at a
    time (``evaluation``: the evaluation program, one tile of ``eval_rows``
    rows at a time)."""

    def __init__(self, packed: PackedTrainPlan, flat_p: torch.Tensor,
                 evaluation: bool = False):
        self.pk = packed
        h = packed.header
        self.mem = flat_p.new_zeros(packed.total_floats)
        self.p = self.mem[h["P"]:h["P"] + packed.n_params]
        self.g = self.mem[h["G"]:h["G"] + packed.n_params]
        self.c = self.mem[h["C"]:h["C"] + packed.flat_consts.numel()]
        self.p.copy_(flat_p)
        self.c.copy_(packed.flat_consts)
        if evaluation:
            self.h, self.bsz = packed.eval_header, packed.eval_rows
            words = packed.eval_prog.tolist()
            n_fwd, n_bwd = packed.n_eval, 0
        else:
            self.h, self.bsz = h, packed.batchsize
            words = packed.prog.tolist()
            n_fwd, n_bwd = packed.n_fwd, packed.n_bwd
        body = words[_HEADER_WORDS:]
        rows = [body[i:i + _INSTR_WORDS]
                for i in range(0, len(body), _INSTR_WORDS)]
        self.fwd, self.bwd = rows[:n_fwd], rows[n_fwd:]
        if len(self.bwd) != n_bwd:
            raise AssertionError("program length does not match its header")

    def rows(self, off, cols):
        return self.mem[off:off + self.bsz * cols].view(self.bsz, cols)

    def vec(self, name):
        off = self.h[name]
        return self.mem[off:off + self.bsz]

    def weight(self, buf, off, k, n):
        return buf[off:off + k * n].view(k, n)

    def load(self, x, theta, mask):
        d, n, h = self.pk.d, self.pk.n, self.h
        self.rows(h["X0"], d).copy_(x)
        if n:
            self.rows(h["TH"], n).copy_(theta)
        self.vec("MASK").copy_(mask)
        self.vec("LDJ").zero_()

    def forward(self):
        d = self.pk.d
        ldj = self.vec("LDJ")
        for ins in self.fwd:
            op = ins[0]
            if op == _F_DENSE:
                _, in1, k1, w1, in2, k2, w2, width, bias, act, out = ins[:11]
                u = self.rows(in1, k1) @ self.weight(self.p, w1, k1, width)
                if k2:
                    u = u + self.rows(in2, k2) @ self.weight(self.p, w2, k2,
                                                            width)
                if bias >= 0:
                    u = u + self.p[bias:bias + width]
                self.rows(out, width).copy_(_act(_ACT_NAMES[act], u))
            elif op == _F_COUPLE:
                _, kind, x_in, x_out, s_b, t_b, e_b, sc_b, cbits = ins[:9]
                x, t = self.rows(x_in, d), self.rows(t_b, d)
                if kind == _KIND_NVP:
                    s = self.rows(s_b, d)
                    clamp = _unbits(cbits)
                    if clamp > 0:
                        s = clamp * torch.tanh(s / clamp)
                    e = torch.exp(-s)
                    self.rows(sc_b, d).copy_(s)
                    self.rows(e_b, d).copy_(e)
                    self.rows(x_out, d).copy_((x - t) * e)
                    ldj -= s.sum(-1)
                else:
                    self.rows(x_out, d).copy_(x - t)
            elif op == _F_ANORM:
                _, x_in, x_out, s_off, b_off = ins[:5]
                s, b = self.p[s_off:s_off + d], self.p[b_off:b_off + d]
                self.rows(x_out, d).copy_((self.rows(x_in, d) - b)
                                          * torch.exp(s))
                ldj += s.sum()
            elif op == _F_AFFINE:
                _, x_in, x_out, a_off, b_off, c_off = ins[:6]
                self.rows(x_out, d).copy_(
                    self.rows(x_in, d) * self.c[a_off:a_off + d]
                    + self.c[b_off:b_off + d])
                ldj += self.c[c_off]
            else:
                raise ValueError(f"opcode {op} in the forward program")
        z = self.rows(self.h["Z"], d)
        self.vec("LP").copy_(_log_prob(z, ldj[:, None])[:, 0])

    def loss(self):
        d, h = self.pk.d, self.h
        m, lp = self.vec("MASK"), self.vec("LP")
        denom = torch.clamp(m.sum(), min=1e-12)
        loss = -(lp * m).sum() / denom
        jbar = -m / denom
        self.vec("JBAR").copy_(jbar)
        self.rows(h["GZ"], d).copy_(-jbar[:, None] * self.rows(h["Z"], d))
        return loss

    def backward(self):
        d = self.pk.d
        jbar = self.vec("JBAR")
        for ins in self.bwd:
            op = ins[0]
            if op == _B_COUPLE:
                _, kind, gz_b, z_b, e_b, sc_b, s_b, t_b, cbits = ins[:9]
                gz = self.rows(gz_b, d)
                if kind == _KIND_NVP:
                    e = self.rows(e_b, d)
                    sbar = -gz * self.rows(z_b, d) - jbar[:, None]
                    clamp = _unbits(cbits)
                    if clamp > 0:
                        sbar = sbar * (1.0 - (self.rows(sc_b, d) / clamp) ** 2)
                    self.rows(s_b, d).copy_(sbar)
                    self.rows(t_b, d).copy_(-gz * e)
                    gz.copy_(gz * e)
                else:
                    self.rows(t_b, d).copy_(-gz)
            elif op == _B_DENSE:
                (_, src, k, w, width, delta_b, bias, dout, acc,
                 dact) = ins[:10]
                a, delta = self.rows(src, k), self.rows(delta_b, width)
                self.weight(self.g, w, k, width).copy_(a.T @ delta)
                if bias >= 0:
                    self.g[bias:bias + width] = delta.sum(0)
                if dout >= 0:
                    v = delta @ self.weight(self.p, w, k, width).T
                    if acc:
                        v = v + self.rows(dout, k)
                    self.rows(dout, k).copy_(
                        _dact_from_value(_ACT_NAMES[dact], a, v))
            elif op == _B_ANORM:
                _, gz_b, z_b, s_off, b_off = ins[:5]
                gz = self.rows(gz_b, d)
                e = torch.exp(self.p[s_off:s_off + d])
                self.g[s_off:s_off + d] = \
                    (gz * self.rows(z_b, d)).sum(0) + jbar.sum()
                self.g[b_off:b_off + d] = -gz.sum(0) * e
                gz.copy_(gz * e)
            elif op == _B_AFFINE:
                _, gz_b, a_off = ins[:3]
                gz = self.rows(gz_b, d)
                gz.copy_(gz * self.c[a_off:a_off + d])
            else:
                raise ValueError(f"opcode {op} in the backward program")


def packed_batch_grads(packed: PackedTrainPlan, flat_p, x, theta, mask):
    """One batch through the lowered forward and backward programs: (loss,
    flat gradient before the 0/1 masks). ``x`` must have ``batchsize`` rows."""
    mach = _Machine(packed, flat_p)
    mach.g.fill_(float("nan"))   # every gradient entry must be written
    mach.load(x, theta, mask)
    mach.forward()
    loss = mach.loss()
    mach.backward()
    return loss, mach.g.clone()


def _packed_log_prob(packed: PackedTrainPlan, flat_p, x, theta):
    """Row log-probs through the lowered forward program, in tiles of
    ``batchsize`` rows (rows past the end are zeros), as the kernel's
    per-epoch evaluation runs it; through the evaluation program, in tiles
    of ``eval_rows``, where the plan has one."""
    evaluation = packed.eval_prog is not None
    mach = _Machine(packed, flat_p, evaluation)
    bsz, rows = mach.bsz, x.shape[0]
    out = []
    for r0 in range(0, rows, bsz):
        xb = x.new_zeros(bsz, packed.d)
        k = min(bsz, rows - r0)
        xb[:k] = x[r0:r0 + k]
        thb = None
        if packed.n:
            thb = x.new_zeros(bsz, packed.n)
            thb[:k] = theta[r0:r0 + k]
        mach.load(xb, thb, x.new_ones(bsz))
        mach.forward()
        out.append(mach.vec("LP")[:k].clone())
    return torch.cat(out)


def packed_train_reference(packed: PackedTrainPlan, tparams, mu, nu, x, theta,
                           x_valid, theta_valid, epoch_perms, *, count0=0,
                           lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                           track_best=False, w=None, w_valid=None,
                           guard_nonfinite=False):
    """The whole run through the lowered program and the flat buffers, in
    PyTorch: what the kernel executes, instruction by instruction. Same
    results as :func:`run_fused_train`. Not a fast path."""
    idx = pad_epoch_perms(epoch_perms, x.shape[0], packed.batchsize)

    def grads_fn(ps, xb, thb, m):
        loss, g = packed_batch_grads(packed, ps[0], xb, thb, m)
        return loss, [g]

    with torch.no_grad():
        out = _train_loop(
            grads_fn,
            lambda ps, xx, tt: _packed_log_prob(packed, ps[0], xx, tt),
            [packed.flatten(tparams)], [packed.flatten(mu)],
            [packed.flatten(nu)], [packed.flat_mask], x, theta, x_valid,
            theta_valid, idx, batchsize=packed.batchsize, count0=count0,
            hp=_adam_scalars(lr, b1, b2, eps), track_best=track_best, w=w,
            w_valid=w_valid, guard=guard_nonfinite)
    p, m, v, tls, vls, best, skips = out
    return (packed.unflatten(p[0]), packed.unflatten(m[0]),
            packed.unflatten(v[0]), tls, vls,
            packed.unflatten(best[0]) if best is not None else None, skips)


# -- the kernel's wrapper ---------------------------------------------------------

_LIB = None
# the kernel's launch bound (csrc/train_kernels.cu, __launch_bounds__)
_MAX_THREADS = 512


def _library():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("train_kernels")
        lib.df_train_run_members.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.df_train_run_members.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _block_threads(packed: PackedTrainPlan) -> int:
    """One thread per element of the widest per-batch array, in whole warps,
    at most 512 (the kernel's launch bound: 128 registers a thread)."""
    work = packed.batchsize * max(packed.hmax, packed.d)
    return int(min(_MAX_THREADS, max(128, (work + 31) // 32 * 32)))


def _phase_names(words, n):
    """One name per phase of a program: its instructions' opcodes joined."""
    names, body = [], words[_HEADER_WORDS:]
    for k in range(n):
        ins = body[k * _INSTR_WORDS:(k + 1) * _INSTR_WORDS]
        name = _OP_NAMES[ins[0]]
        if ins[_W_JOIN]:
            names[-1] += "+" + name
        else:
            names.append(name)
    return names


def run_phase_names(packed: PackedTrainPlan):
    """The phases of one ``train_run`` step and of one evaluation tile, in
    order, as the DF_TRAIN_CLOCKS build records them (tools/chip_probe.py)."""
    words = packed.prog.tolist()
    fwd = _phase_names(words, packed.n_fwd)
    body = words[:_HEADER_WORDS] + words[
        _HEADER_WORDS + packed.n_fwd * _INSTR_WORDS:]
    bwd = _phase_names(body, packed.n_bwd)
    step = (["load_batch"] + fwd + ["lp_cotangents"] + bwd
            + ["mask_and_check", "adam_update"])
    ev = _phase_names(packed.eval_prog.tolist(), packed.n_eval)
    return step, ["eval_fold+load_rows"] + ev + ["eval_lp"]


def run_layout(packed: PackedTrainPlan, n_train: int = 0,
               n_valid: int = 0) -> dict:
    """The shape of a ``train_run`` launch: phases per step, per evaluation
    tile and (given the split sizes) per epoch, the evaluation tile's rows,
    whether the nets are paired and the programs staged."""
    step, tile = run_phase_names(packed)
    out = dict(phases_per_step=len(step), phases_per_eval_tile=len(tile),
               eval_rows=packed.eval_rows, paired=packed.paired,
               staged=packed.staged, shared_bytes=packed.shared_bytes,
               instructions=dict(forward=packed.n_fwd,
                                 backward=packed.n_bwd,
                                 evaluation=packed.n_eval))
    if n_train:
        tiles = (-(-n_train // packed.eval_rows)
                 + -(-n_valid // packed.eval_rows))
        batches = -(-n_train // packed.batchsize)
        # the epoch: its steps, its tiles, the last fold, the totals, the
        # histories
        out["eval_tiles_per_epoch"] = tiles
        out["phases_per_epoch"] = (batches * len(step) + tiles * len(tile)
                                   + 3)
    return out


def _device_f32(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.contiguous()


def _train_run_members(launch, plan, tparams, masks, mask_slots, cparams, mu,
                       nu, x, theta, x_valid, theta_valid, epoch_perms, *,
                       batchsize, count0, lr, b1, b2, eps, track_best, w,
                       w_valid, guard_nonfinite, packed, threads):
    """Check the arguments, lay out the buffers on ``x``'s device and hand
    them to ``launch(ptrs, iargs, fargs, members, threads, shared_bytes) →
    error code``, the C entry point of ``csrc/train_kernels.cu``.
    ``tparams`` / ``mu`` / ``nu`` / ``epoch_perms``: one entry per member,
    laid out one member after another; returns one result tuple per
    member."""
    device = x.device
    n_rows, d = x.shape
    n_valid = x_valid.shape[0]
    n_cond = theta.shape[-1] if theta is not None else 0
    members = len(tparams)
    if members < 1 or not len(mu) == len(nu) == len(epoch_perms) == members:
        raise ValueError(
            "pass one entry of tparams, mu, nu and epoch_perms per member")
    if (w is None) != (w_valid is None):
        raise ValueError("pass both w and w_valid, or neither")
    if n_rows == 0 or n_valid == 0:
        raise ValueError("empty training or validation split")
    if packed is None:
        packed = pack_train_plan(plan, tparams[0], masks, mask_slots, cparams,
                                 d, n_cond, batchsize)
    if (packed.plan != tuple(plan) or packed.d != d or packed.n != n_cond
            or packed.batchsize != batchsize):
        raise ValueError("packed plan was lowered for another run")
    if packed.shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"train_run needs {packed.shared_bytes} bytes of shared memory "
            f"(limit {MAX_SHARED_BYTES})")
    if packed.eval_prog is None:
        raise ValueError("packed plan has no evaluation program: lower it "
                         "with state_in_shared=True")
    idx = [pad_epoch_perms(p, n_rows, batchsize) for p in epoch_perms]
    epochs, n_pad = idx[0].shape
    if any(i.shape != (epochs, n_pad) for i in idx):
        raise ValueError("every member needs as many epochs")
    if epochs == 0:
        raise ValueError("epochs must be at least 1")
    if threads is None:
        threads = _block_threads(packed)
    if threads % 32 or not 32 <= threads <= _MAX_THREADS:
        raise ValueError(
            f"threads must be a multiple of 32, at most {_MAX_THREADS}")

    x = _device_f32(x, "x", (n_rows, d), device)
    x_valid = _device_f32(x_valid, "x_valid", (n_valid, d), device)
    if n_cond:
        theta = _device_f32(theta, "theta", (n_rows, n_cond), device)
        theta_valid = _device_f32(theta_valid, "theta_valid",
                                  (n_valid, n_cond), device)
    if w is not None:
        w = _device_f32(w.reshape(-1), "w", (n_rows,), device)
        w_valid = _device_f32(w_valid.reshape(-1), "w_valid", (n_valid,),
                              device)
    flat = {name: _stack_members(packed, per_member, name, device)
            for name, per_member in (("params", tparams), ("mu", mu),
                                     ("nu", nu))}
    if packed.prog.device != device:
        raise ValueError(
            f"plan parameters are on {packed.prog.device}, data on {device}")
    order = np.stack(idx)
    with span("df.upload") as up:
        if up.recording:
            up.counts["bytes"] = order.nbytes
        perm = torch.as_tensor(order, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    out = {name: torch.empty(members, packed.n_params, **f32)
           for name in ("params", "mu", "nu")}
    hist = {name: torch.empty(members, epochs, **f32)
            for name in ("t", "v", "s")}
    best = torch.empty(members, packed.n_params if track_best else 0, **f32)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    ptrs = (ctypes.c_void_p * 21)(
        ptr(x), ptr(theta if n_cond else None), ptr(w), ptr(perm),
        ptr(x_valid), ptr(theta_valid if n_cond else None), ptr(w_valid),
        ptr(flat["params"]), ptr(flat["mu"]), ptr(flat["nu"]),
        ptr(packed.flat_mask), ptr(packed.flat_consts), ptr(packed.prog),
        ptr(out["params"]), ptr(out["mu"]), ptr(out["nu"]), ptr(hist["t"]),
        ptr(hist["v"]), ptr(hist["s"]), ptr(best), ptr(packed.eval_prog))
    iargs = (ctypes.c_int * 8)(
        epochs, n_pad // batchsize, n_rows, n_valid, int(count0),
        int(bool(track_best)), int(w is not None), int(bool(guard_nonfinite)))
    hp = _adam_scalars(lr, b1, b2, eps)
    fargs = (ctypes.c_float * 8)(*(float(hp[k]) for k in (
        "lr", "b1", "b2", "eps", "omb1", "omb2", "logb1", "logb2")))
    err = launch(ptrs, iargs, fargs, members, int(threads),
                 packed.shared_bytes)
    if err != 0:
        raise RuntimeError(f"train_run launch failed (CUDA error {err})")
    # each output tensor once for all members (one copy a folded tensor),
    # member k's the views [k]
    params, mus, nus = (_unstack_members(packed, out[name])
                        for name in ("params", "mu", "nu"))
    bests = _unstack_members(packed, best) if track_best else None
    skips = hist["s"].to(torch.int32) if guard_nonfinite else None
    return [([t[k] for t in params], [t[k] for t in mus],
             [t[k] for t in nus], hist["t"][k], hist["v"][k],
             [t[k] for t in bests] if track_best else None,
             skips[k] if guard_nonfinite else None)
            for k in range(members)]


def _stack_members(packed, per_member, name, device):
    """``(K, n_params)``: the members' folded tensors in the packed order,
    one stack a folded tensor and one concatenation, whatever K."""
    for ts in per_member:
        if len(ts) != len(packed.shapes):
            raise ValueError(f"expected {len(packed.shapes)} folded tensors, "
                             f"got {len(ts)}")
        for t, shape in zip(ts, packed.shapes):
            _device_f32(t, name, shape, device)
    return torch.cat([torch.stack([ts[j].reshape(-1) for ts in per_member])
                      for j in range(len(packed.shapes))], 1).contiguous()


def _unstack_members(packed, flat):
    """The inverse of :func:`_stack_members`: one ``(K, *shape)`` tensor a
    folded tensor."""
    k = flat.shape[0]
    return [flat[:, o:o + int(np.prod(s))].reshape((k,) + tuple(s)).clone()
            for o, s in zip(packed.offsets, packed.shapes)]


def run_fused_train(plan, tparams, masks, mask_slots, cparams, mu, nu, x,
                    theta, x_valid, theta_valid, epoch_perms, *, batchsize,
                    count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                    track_best=False, w=None, w_valid=None,
                    guard_nonfinite=False, packed=None):
    """Run a whole training run on folded parameters as one kernel.

    ``x`` (n, d) / ``theta`` (n, n_cond) or None: the normalized training
    rows; ``x_valid`` / ``theta_valid``: the validation split; ``w`` /
    ``w_valid``: per-row importance weights or None. ``epoch_perms``:
    ``(epochs, n)`` row permutations, one per epoch. ``mu`` / ``nu`` /
    ``count0``: the Adam state to continue from; state, count and sliced
    permutations carried from one call into the next give the same result as
    one call, bit for bit.

    Returns ``(params, mu, nu, train_hist, valid_hist, best, skips)``: the
    folded tensors and moments after the run, the per-epoch full-split NLLs
    (from the parameters after each epoch's last batch), the folded snapshot
    at the lowest-validation-NLL epoch when ``track_best`` (else None), and
    the per-epoch counts of skipped non-finite updates when
    ``guard_nonfinite`` (else None). A guarded step that is skipped leaves
    parameters and moments as they are and does not advance the Adam step.

    On CUDA tensors this launches ``train_run`` on the current stream and
    raises when the block's working set exceeds the shared memory of one
    block; on CPU tensors it runs :func:`fused_train_plain`.
    """
    return run_fused_train_members(
        plan, [tparams], masks, mask_slots, cparams, [mu], [nu], x, theta,
        x_valid, theta_valid, [epoch_perms], batchsize=batchsize,
        count0=count0, lr=lr, b1=b1, b2=b2, eps=eps, track_best=track_best,
        w=w, w_valid=w_valid, guard_nonfinite=guard_nonfinite,
        packed=packed)[0]


run_fused_train.launches = 0


def run_fused_train_members(plan, tparams, masks, mask_slots, cparams, mu, nu,
                            x, theta, x_valid, theta_valid, epoch_perms, *,
                            batchsize, count0=0, lr=1e-3, b1=0.9, b2=0.999,
                            eps=1e-8, track_best=False, w=None, w_valid=None,
                            guard_nonfinite=False, packed=None):
    """K independent runs of one plan, as :func:`run_fused_train` runs one:
    ``tparams`` / ``mu`` / ``nu`` / ``epoch_perms`` hold one entry per
    member (its folded tensors, its moments, its ``(epochs, n)`` batch
    order); the rows, weights, constants and hyperparameters are shared.
    Returns one :func:`run_fused_train` result tuple per member.

    On CUDA tensors this is ONE launch of ``train_run`` with K blocks, block
    k training member k with the body a one-member launch runs, so member k
    equals its own :func:`run_fused_train` bit for bit. On CPU tensors it
    runs :func:`fused_train_plain` once per member."""
    device = x.device
    kw = dict(batchsize=batchsize, count0=count0, lr=lr, b1=b1, b2=b2,
              eps=eps, track_best=track_best, w=w, w_valid=w_valid,
              guard_nonfinite=guard_nonfinite)
    if device.type == "cpu":
        if not len(mu) == len(nu) == len(epoch_perms) == len(tparams):
            raise ValueError("pass one entry of tparams, mu, nu and "
                             "epoch_perms per member")
        return [fused_train_plain(plan, tp, masks, mask_slots, cparams, m,
                                  v, x, theta, x_valid, theta_valid, p, **kw)
                for tp, m, v, p in zip(tparams, mu, nu, epoch_perms)]
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        out = _train_run_members(
            lambda *a: _library().df_train_run_members(*a, stream), plan,
            tparams, masks, mask_slots, cparams, mu, nu, x, theta, x_valid,
            theta_valid, epoch_perms, packed=packed, threads=None, **kw)
    run_fused_train.launches += 1
    return out
