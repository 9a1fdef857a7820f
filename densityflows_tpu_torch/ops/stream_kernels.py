"""Streaming whole-run training on folded parameters: the ``train_stream``
CUDA kernel's wrapper, its plain PyTorch version and the per-epoch
evaluation of its snapshots.

PyTorch/CUDA counterpart of ``densityflows_tpu/ops/pallas_train_stream.py``.
``train_run`` (``ops/train_kernels.py``) keeps the parameters, both Adam
moments and the gradients in one block's shared memory, which caps the
model. This kernel keeps them in device memory and splits every batch over
many blocks of one persistent cooperative launch: per step the row tiles'
gradient partials, their sum in block order with the 0/1 masks as a select
and the guard, then Adam on every block's slice (``csrc/stream_kernels.cu``
says how the blocks keep in order). One launch runs a chunk of epochs and
writes a snapshot of the folded parameters after each epoch's last batch;
the per-epoch NLL histories are computed outside, from the snapshots.

Plans, folded tensors, masks and constants are those of
``ops/train_kernels.py``; the lowering and the flat layout are the step
kernel's (:class:`~.step_kernels.StepPlan`: the shared memory of a block
holds one row tile's rows and caches only). Batch order is
``epoch_perms``, an ``(epochs, n)`` array of per-epoch row permutations; the
final partial batch is padded with row 0 and masked by position, importance
weights multiply the mask.

- :func:`run_fused_train_stream` — the wrapper. On CUDA tensors it launches
  ``train_stream`` (it replaces
  ``densityflows_tpu/ops/pallas_train_stream.py::_stream_kernel``) or raises;
  on CPU tensors it runs :func:`fused_train_stream_plain`.
  ``run_fused_train_stream.launches`` counts kernel launches.
- :func:`fused_train_stream_plain` — plain PyTorch, the same per-step algebra
  (``step_grads_plain`` and the kernels' Adam).
- :func:`eval_snapshots` — plain PyTorch: per-epoch full-split NLLs of the
  stacked snapshots, in row chunks.
- :func:`stream_reason` / :func:`stream_shared_bytes` / :func:`launch_shape`
  — the envelope (the caches of one row in one block's shared memory) and
  the row tile, threads, residency and grid of a launch.
- :func:`batch_denominators` — every batch's ``Σ mask`` in the kernel's
  fixed lane order, computed before the launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.spans import span
from .chain_kernels import MAX_SHARED_BYTES
from .step_kernels import (
    STEP_MAX_THREADS,
    StepPlan,
    _full_f32,
    step_grads_plain,
)
from .train_kernels import (
    _adam_scalars,
    _adam_step,
    _device_f32,
    _folded_log_prob,
    pad_epoch_perms,
)

__all__ = ["run_fused_train_stream", "fused_train_stream_plain",
           "eval_snapshots", "stream_reason", "stream_shared_bytes",
           "launch_shape", "batch_denominators", "MAX_SHARED_BYTES"]

# a batch's denominator is summed in this many strided lanes, then the lanes
# in order: one fixed order of f32 adds
DENOM_LANES = 32


def stream_reason(sp: StepPlan):
    """``None`` when ``train_stream`` can run the plan, else why not: the
    activation caches of ONE row must fit one block's shared memory. Parameters, moments and gradients lie in device
    memory, so their size does not count."""
    need = sp.shared_bytes(1)
    if need > MAX_SHARED_BYTES:
        return (f"train_stream needs {need} bytes of shared memory for the "
                f"activation caches of one row and a block has "
                f"{MAX_SHARED_BYTES}: conditioners too deep or too wide for "
                "the streaming kernel")
    return None


def _stream_tile(sp: StepPlan, batchsize: int) -> int:
    """The step kernel's row tile for the batch, narrower while its caches
    do not fit one block."""
    reason = stream_reason(sp)
    if reason is not None:
        raise ValueError(reason)
    tile = sp.pick_tile(batchsize)
    while sp.shared_bytes(tile) > MAX_SHARED_BYTES:
        tile //= 2
    return tile


def _stream_block(sp: StepPlan, batchsize: int, stage=None):
    """``(tile, threads, shared_bytes, staged)`` of one block: the tile of
    :func:`_stream_tile`, step_grads' threads (at most
    ``STEP_MAX_THREADS``, the kernels' launch bound), the parameters,
    constants and program staged in shared memory wherever they fit beside
    the tile (``stage`` forces it either way; True where they do not fit
    raises ``ValueError``)."""
    tile = _stream_tile(sp, batchsize)
    fits = sp.shared_bytes(tile, True) <= MAX_SHARED_BYTES
    staged = fits if stage is None else bool(stage)
    if staged and not fits:
        raise ValueError(
            f"train_stream: {sp.shared_bytes(tile, True)} bytes of shared "
            f"memory to stage the parameters at a tile of {tile} rows "
            f"(limit {MAX_SHARED_BYTES})")
    return (tile, min(STEP_MAX_THREADS, sp.threads(tile)),
            sp.shared_bytes(tile, staged), staged)


def stream_shared_bytes(sp: StepPlan, batchsize: int) -> int:
    """Dynamic shared memory of one block for batches of ``batchsize``
    rows (the parameters staged where they fit)."""
    return _stream_block(sp, batchsize)[2]


def launch_shape(sp: StepPlan, batchsize: int, co_resident=None,
                 n_blocks=None, stage=None):
    """``(tile, threads, shared_bytes, n_blocks, staged)`` of a launch, all
    in one place: the step kernel's tile and threads (``StepPlan.pick_tile``
    / ``threads``, at most ``STEP_MAX_THREADS``), the parameters staged in
    shared memory wherever they fit beside the tile (``stage`` forces it),
    and the grid (one block per tile, at most its cap), at most
    ``co_resident`` blocks of that shape — a cooperative launch needs every
    block resident at once. An explicit ``n_blocks`` beyond either limit is
    refused."""
    tile, threads, shared, staged = _stream_block(sp, batchsize, stage)
    n_tiles = -(-batchsize // tile)
    if co_resident is not None and co_resident < 1:
        raise ValueError(
            f"train_stream: no block of {threads} threads and "
            f"{shared} bytes of shared memory can be resident, or the device "
            "has no cooperative launch")
    if n_blocks is None:
        n_blocks = sp.grid(batchsize, tile)
        if co_resident is not None:
            n_blocks = min(n_blocks, co_resident)
    if co_resident is not None and n_blocks > co_resident:
        raise ValueError(
            f"train_stream: a grid of {n_blocks} blocks, but only "
            f"{co_resident} blocks of {threads} threads and "
            f"{shared} bytes of shared memory can be resident at once")
    if not 1 <= n_blocks <= n_tiles:
        raise ValueError(
            f"train_stream: {n_blocks} blocks for {n_tiles} row tiles; every "
            "block needs a tile")
    return tile, threads, shared, int(n_blocks), staged


def batch_denominators(idx, n_rows: int, batchsize: int, w=None):
    """``(epochs · n_batches,)`` float32: every batch's ``Σ mask`` clamped at
    1e-12, for the kernel. ``idx``: the padded ``(epochs, n_batches ·
    batchsize)`` order (:func:`pad_epoch_perms`), as a tensor on the
    kernel's device; a position's mask is 1 inside the ``n_rows`` training
    rows and 0 on the pad, times ``w`` of its row where weights are given.
    Position q of a batch goes to lane q mod DENOM_LANES, each lane a sum in
    q order from 0, then the lanes in order from 0, and the clamp keeps 1e-12
    for a NaN sum (as ``fmaxf`` does)."""
    epochs, n_pad = idx.shape
    n_batches = n_pad // batchsize
    mask = (torch.arange(n_pad, device=idx.device) < n_rows).to(
        torch.float32).expand(epochs, n_pad)
    if w is not None:
        mask = mask * w.reshape(-1)[idx.long()]
    rounds = -(-batchsize // DENOM_LANES)
    lanes_in = mask.new_zeros(epochs, n_batches, rounds * DENOM_LANES)
    lanes_in[:, :, :batchsize] = mask.reshape(epochs, n_batches, batchsize)
    lanes_in = lanes_in.reshape(epochs, n_batches, rounds, DENOM_LANES)
    lanes = mask.new_zeros(epochs, n_batches, DENOM_LANES)
    for r in range(rounds):
        lanes = lanes + lanes_in[:, :, r]
    total = mask.new_zeros(epochs, n_batches)
    for lane in range(DENOM_LANES):
        total = total + lanes[:, :, lane]
    floor = torch.full_like(total, 1e-12)
    return torch.where(total >= floor, total, floor).reshape(-1).contiguous()


# -- the plain version ----------------------------------------------------------

def fused_train_stream_plain(plan, tparams, masks, mask_slots, cparams, mu, nu,
                             x, theta, epoch_perms, *, batchsize, count0=0,
                             lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, w=None,
                             guard_nonfinite=False, with_losses=False):
    """Plain PyTorch version of ``train_stream``; same arguments and results
    as :func:`run_fused_train_stream`. Each step is ``step_grads_plain`` on
    the whole batch (the gradients come back select-masked), the guard on
    the loss and the masked gradients, and the kernels' Adam."""
    n = x.shape[0]
    idx = pad_epoch_perms(epoch_perms, n, batchsize)
    epochs, n_pad = idx.shape
    n_batches = n_pad // batchsize
    idx_t = torch.as_tensor(idx, device=x.device).long()
    pos_mask = (torch.arange(n_pad, device=x.device) < n).to(x.dtype)
    th = theta if theta is not None and theta.shape[-1] else None
    hp = {k: float(v) for k, v in _adam_scalars(lr, b1, b2, eps).items()}
    params = [p.clone() for p in tparams]
    mu = [m.clone() for m in mu]
    nu = [v.clone() for v in nu]
    snaps = [[] for _ in tparams]
    skips, losses = [], []
    applied = 0
    with torch.no_grad():
        for e in range(epochs):
            e_skips = 0
            for b in range(n_batches):
                sl = slice(b * batchsize, (b + 1) * batchsize)
                rows = idx_t[e, sl]
                m = pos_mask[sl]
                if w is not None:
                    m = m * w[rows]
                loss, grads = step_grads_plain(
                    plan, params, masks, mask_slots, cparams, x[rows],
                    th[rows] if th is not None else None, m)
                losses.append(loss)
                if guard_nonfinite and not (
                        bool(torch.isfinite(loss))
                        and all(bool(torch.isfinite(g).all()) for g in grads)):
                    e_skips += 1
                    continue
                _adam_step(params, mu, nu, grads, count0 + applied + 1, hp)
                applied += 1
            for s, p in zip(snaps, params):
                s.append(p.clone())
            skips.append(e_skips)
    out = (params, mu, nu, [torch.stack(s) for s in snaps],
           torch.tensor(skips, dtype=torch.int32, device=x.device)
           if guard_nonfinite else None)
    if with_losses:
        out += (torch.stack(losses).reshape(-1),)
    return out


# -- the evaluation of the snapshots ----------------------------------------------

def eval_snapshots(snaps, cparams, x, theta, w, *, plan, row_chunk=4096):
    """Per-epoch full-split NLLs for every snapshot: ``snaps`` holds per
    folded tensor the ``(E,) + shape`` stack of the epochs' snapshots.
    Rows are taken ``row_chunk`` at a time, so the memory is
    O(row_chunk × width) whatever the row count. Returns the ``(E,)`` vector
    ``−Σ m·lp / max(Σ m, 1e-12)`` with ``m`` = 1, or ``w`` when given."""
    n_rows = x.shape[0]
    th = theta if theta is not None and theta.shape[-1] else None
    e_count = snaps[0].shape[0]
    s_lp = x.new_zeros(e_count)
    s_m = x.new_zeros(e_count)
    with torch.no_grad(), _full_f32():
        for r0 in range(0, n_rows, row_chunk):
            sl = slice(r0, r0 + row_chunk)
            xc = x[sl]
            m = (w.reshape(-1)[sl] if w is not None
                 else x.new_ones(xc.shape[0]))
            for e in range(e_count):
                lp = _folded_log_prob(plan, [s[e] for s in snaps],
                                      list(cparams), xc,
                                      th[sl] if th is not None else None)
                s_lp[e] += (lp * m).sum()
                s_m[e] += m.sum()
    return -s_lp / torch.clamp(s_m, min=1e-12)


# -- the kernel's wrapper ---------------------------------------------------------------

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("stream_kernels")
        lib.df_train_stream.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.df_train_stream.restype = ctypes.c_int
        lib.df_train_stream_max_blocks.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.df_train_stream_max_blocks.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def co_resident_blocks(threads: int, shared_bytes: int) -> int:
    """Blocks of ``train_stream`` with this shape that the current CUDA
    device can hold at once (occupancy per SM times the SM count; 0 where
    the device has no cooperative launch)."""
    out = ctypes.c_int(0)
    err = _library().df_train_stream_max_blocks(int(threads),
                                                 int(shared_bytes),
                                                 ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"train_stream occupancy query failed (CUDA error "
                           f"{err})")
    return out.value


def device_launch_shape(sp: StepPlan, batchsize: int, n_blocks=None):
    """:func:`launch_shape` on the current CUDA device, its grid capped at
    the blocks of that shape (threads, shared memory with the staged
    parameters where they are staged) the device can hold at once."""
    return launch_shape(sp, batchsize, co_resident_blocks(
        *_stream_block(sp, batchsize)[1:3]), n_blocks)


def _train_stream(launch, sp: StepPlan, tparams, mu, nu, x, theta,
                  epoch_perms, *, batchsize, count0, lr, b1, b2, eps, w,
                  guard_nonfinite, with_losses, shape, clocks=None):
    """Check the arguments, lay out the buffers on ``x``'s device and hand
    them to ``launch(ptrs, iargs, fargs, threads, shared_bytes, n_blocks) →
    error code``, the C entry point of ``csrc/stream_kernels.cu``.
    ``shape``: :func:`launch_shape`'s ``(tile, threads, shared_bytes,
    n_blocks, staged)``. ``clocks``: a float32 buffer on the device for the cycle
    counts of the ``DF_STREAM_CLOCKS`` build, or None."""
    device = x.device
    n_rows, d = x.shape
    n_cond = theta.shape[-1] if theta is not None else 0
    if d != sp.d or n_cond != sp.n:
        raise ValueError(
            f"plan was lowered for d {sp.d}, n {sp.n}; got d {d}, n {n_cond}")
    if n_rows == 0:
        raise ValueError("empty training split")
    if sp.device != device:
        raise ValueError(
            f"plan parameters are on {sp.device}, data on {device}")
    tile, threads, shared, n_blocks, staged = shape
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"train_stream needs {shared} bytes of shared "
                         f"memory (limit {MAX_SHARED_BYTES})")
    idx = pad_epoch_perms(epoch_perms, n_rows, batchsize)
    epochs, n_pad = idx.shape
    if epochs == 0:
        raise ValueError("epochs must be at least 1")
    n_batches = n_pad // batchsize
    n_tiles = -(-batchsize // tile)
    packed = sp.packed(tile)

    x = _device_f32(x, "x", (n_rows, d), device)
    if n_cond:
        theta = _device_f32(theta, "theta", (n_rows, n_cond), device)
    if w is not None:
        w = _device_f32(w.reshape(-1), "w", (n_rows,), device)
    # the kernel updates these three in place: fresh buffers
    state = [_device_f32(sp.flatten(ts), name, (sp.n_params,), device).clone()
             for name, ts in (("params", tparams), ("mu", mu), ("nu", nu))]
    with span("df.upload") as up:
        if up.recording:
            up.counts["bytes"] = idx.nbytes
        perm = torch.as_tensor(idx, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    n_p = sp.n_params
    partial = torch.empty(n_blocks * (n_p + 1), **f32)
    grad = torch.empty(n_p + 1, **f32)
    flags = torch.empty(n_blocks, **f32)
    snaps = torch.empty(epochs, n_p, **f32)
    skips = torch.empty(epochs, **f32)
    losses = torch.empty(epochs * n_batches if with_losses else 0, **f32)
    denoms = batch_denominators(perm, n_rows, batchsize, w)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    ptrs = (ctypes.c_void_p * 18)(
        ptr(x), ptr(theta if n_cond else None), ptr(w), ptr(perm),
        ptr(packed.flat_mask), ptr(packed.flat_consts), ptr(packed.prog),
        ptr(state[0]), ptr(state[1]), ptr(state[2]), ptr(partial), ptr(grad),
        ptr(flags), ptr(snaps), ptr(skips), ptr(losses), ptr(clocks),
        ptr(denoms))
    iargs = (ctypes.c_int * 9)(
        epochs, n_batches, batchsize, n_rows, n_tiles, int(count0),
        int(w is not None), int(bool(guard_nonfinite)), int(staged))
    hp = _adam_scalars(lr, b1, b2, eps)
    fargs = (ctypes.c_float * 8)(*(float(hp[k]) for k in (
        "lr", "b1", "b2", "eps", "omb1", "omb2", "logb1", "logb2")))
    err = launch(ptrs, iargs, fargs, int(threads), int(shared), int(n_blocks))
    if err != 0:
        raise RuntimeError(f"train_stream launch failed (CUDA error {err})")
    out = (sp.unflatten(state[0]), sp.unflatten(state[1]),
           sp.unflatten(state[2]),
           [snaps[:, o:o + int(np.prod(s))].reshape((epochs,) + s)
            .contiguous() for o, s in zip(sp.offsets, sp.shapes)],
           skips.to(torch.int32) if guard_nonfinite else None)
    if with_losses:
        out += (losses,)
    return out


def run_fused_train_stream(plan, tparams, masks, mask_slots, cparams, mu, nu,
                           x, theta, epoch_perms, *, batchsize, count0=0,
                           lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, w=None,
                           guard_nonfinite=False, with_losses=False,
                           step_plan=None, n_blocks=None, clocks=None):
    """Run ``len(epoch_perms)`` epochs of training on folded parameters as
    one streaming kernel.

    ``x`` (n, d) / ``theta`` (n, n_cond) or None: the normalized training
    rows; ``w``: per-row importance weights or None. ``epoch_perms``:
    ``(epochs, n)`` row permutations, one per epoch. ``mu`` / ``nu`` /
    ``count0``: the Adam state to continue from; state, count and sliced
    permutations carried from one call into the next give the same result
    as one call, bit for bit.

    Returns ``(params, mu, nu, snaps, skips)``: the folded tensors and
    moments after the run, per folded tensor the ``(epochs,) + shape`` stack
    of its values after each epoch's last batch (for :func:`eval_snapshots`),
    and the per-epoch counts of skipped non-finite updates when
    ``guard_nonfinite`` (else None). ``with_losses=True`` appends the
    ``(epochs · n_batches,)`` per-step batch losses.

    On CUDA tensors this launches ``train_stream`` on the current stream or
    raises; on CPU tensors it runs :func:`fused_train_stream_plain`.
    ``step_plan``: the plan lowered once (:class:`StepPlan`), else lowered
    here. ``n_blocks``: the grid (default :func:`launch_shape`'s).
    ``clocks``: a float32 CUDA buffer for the cycle counts of a
    ``DF_STREAM_CLOCKS`` build of the kernel (``tools/chip_probe.py``),
    else None."""
    device = x.device
    kw = dict(batchsize=batchsize, count0=count0, lr=lr, b1=b1, b2=b2,
              eps=eps, w=w, guard_nonfinite=guard_nonfinite,
              with_losses=with_losses)
    if device.type == "cpu":
        return fused_train_stream_plain(plan, tparams, masks, mask_slots,
                                        cparams, mu, nu, x, theta,
                                        epoch_perms, **kw)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    sp = step_plan
    if sp is None:
        n_cond = theta.shape[-1] if theta is not None else 0
        sp = StepPlan(plan, list(tparams), masks, mask_slots, cparams,
                      x.shape[-1], n_cond)
    with torch.cuda.device(device):
        shape = device_launch_shape(sp, batchsize, n_blocks)
        stream = torch.cuda.current_stream().cuda_stream
        out = _train_stream(
            lambda *a: _library().df_train_stream(*a, stream), sp,
            list(tparams), list(mu), list(nu), x, theta, epoch_perms,
            shape=shape, clocks=clocks, **kw)
    run_fused_train_stream.launches += 1
    return out


run_fused_train_stream.launches = 0
