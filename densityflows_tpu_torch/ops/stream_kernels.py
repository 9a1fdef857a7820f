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

Two designs run the same step (``csrc/stream_kernels.cu``); the launch
rule :func:`uses_tc` picks one from the plan's shape and the batch. The tile
body (``csrc/grads_tile.cuh``) keeps a row tile's caches in a block's
shared memory and wins where one round of its tiles covers the batch; the
tensor-core design (``csrc/stream_tc.cuh``) folds tiles of ``TC_ROWS`` rows
whose caches lie in a device workspace, runs the products on the tensor
cores in 3xTF32 and sums the weight gradients over segments of the batch,
and wins where the tile body would take several rounds of small tiles
(measured on an H100, ``PERF.md``), as long as its workspace, which grows
with the batch, stays within ``TC_WORKSPACE_BYTES``.

Plans, folded tensors, masks and constants are those of
``ops/train_kernels.py``; the lowering and the flat layout are the step
kernel's (:class:`~.step_kernels.StepPlan`: the shared memory of a block
holds one row tile's rows and caches only; the tensor-core design's tile
layout keeps every dense layer's cotangent, ``keep_deltas``). Batch order is
``epoch_perms``, an ``(epochs, n)`` array of per-epoch row permutations; the
final partial batch is padded with row 0 and masked by position, importance
weights multiply the mask.

- :func:`run_fused_train_stream` — the wrapper. On CUDA tensors it launches
  ``train_stream`` (it replaces
  ``densityflows_tpu/ops/pallas_train_stream.py::_stream_kernel``) or raises;
  on CPU tensors it runs :func:`fused_train_stream_plain`.
  ``run_fused_train_stream.launches`` counts kernel launches,
  ``.tc_launches`` those of the tensor-core design.
- :func:`fused_train_stream_plain` — plain PyTorch, the same per-step algebra
  (``step_grads_plain`` and the kernels' Adam).
- :func:`eval_snapshots` — plain PyTorch: per-epoch full-split NLLs of the
  stacked snapshots, in row chunks.
- :func:`stream_reason` / :func:`stream_shared_bytes` / :func:`launch_shape`
  — the envelope (the caches of one row in one block's shared memory) and
  the design, row tile, threads, residency and grid of a launch;
  :func:`uses_tc`, :func:`tc_reason`, :func:`tc_items` and
  :func:`stream_workspace_bytes` — the tensor-core design's rule, envelope,
  weight-gradient items and workspace.
- :func:`batch_denominators` — every batch's ``Σ mask`` in the kernel's
  fixed lane order, computed before the launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.spans import span
from .chain_kernels import MAX_SHARED_BYTES
from .step_kernels import (
    STEP_MAX_THREADS,
    StepPlan,
    _align4,
    _full_f32,
    step_grads_plain,
)
from .train_kernels import (
    _B_ANORM,
    _B_DENSE,
    _HEADER_WORDS,
    _INSTR_WORDS,
    _adam_scalars,
    _adam_step,
    _device_f32,
    _folded_log_prob,
    _H_NBWD,
    _H_NFWD,
    pad_epoch_perms,
)

__all__ = ["run_fused_train_stream", "fused_train_stream_plain",
           "eval_snapshots", "stream_reason", "stream_shared_bytes",
           "launch_shape", "batch_denominators", "tc_reason",
           "stream_workspace_bytes", "uses_tc", "StreamShape",
           "MAX_SHARED_BYTES"]

# a batch's denominator is summed in this many strided lanes, then the lanes
# in order: one fixed order of f32 adds
DENOM_LANES = 32

# The tensor-core design (csrc/stream_tc.cuh): tiles of TC_ROWS rows, blocks
# of TC_THREADS threads with TC_SHARED_BYTES of shared memory (its
# TC_SHARED_FLOATS), weight-gradient items of TC_ITEM x TC_ITEM outputs over
# segments of TC_SEG_TILES tiles.
TC_ROWS = 64
TC_THREADS = 512
TC_SHARED_BYTES = 4 * (2 * (TC_ROWS + 2 * 256) * 36 + 2 * TC_ROWS * 36 + 8)
TC_ITEM = 128
TC_SEG_TILES = 16
# The launch rule: the tensor-core design where it can run the plan and the
# tile body (grads_tile.cuh), whose row tile is as wide as a block's shared
# memory holds the caches of, would cut the batch into more than
# TC_MIN_TILES tiles (about one a SM: then its blocks re-read every weight
# and rewrite their gradient partials tile after tile); else the tile
# body, which wins where one round of its tiles covers the batch.
TC_MIN_TILES = 128
# The tensor-core design's workspace holds every tile's caches, so it grows
# with the batch (about 72 KB a row at the 32-D emulator's plan). The rule
# keeps it within TC_WORKSPACE_BYTES, half of train()'s per-call budget of
# device memory (models/fused_train.py's _STREAM_DEVICE_BUDGET), and leaves
# a larger batch to the tile body, whose memory does not grow with the batch.
TC_WORKSPACE_BYTES = 80_000_000_000 // 16


class StreamShape(NamedTuple):
    """A ``train_stream`` launch: the design (``tc``: the tensor-core one),
    its row tile, threads, dynamic shared memory and grid, and whether the
    parameters are staged in shared memory (the tile body only)."""
    tile: int
    threads: int
    shared_bytes: int
    n_blocks: int
    staged: bool
    tc: bool


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
    return launch_shape(sp, batchsize).shared_bytes


def tc_reason(sp: StepPlan):
    """``None`` when the tensor-core design can run the plan, else why not:
    its weight gradients are the dense layers' a^T.delta and bias sums, so
    every folded parameter must belong to one dense layer."""
    reason = sp._tc.get("reason", False)
    if reason is False:
        pk = sp.packed(TC_ROWS, keep_deltas=True)
        bwd = _bwd_instructions(pk.prog.cpu().numpy())
        # the dense layers' weights and biases must tile the parameters
        spans = sorted([(ins[3], ins[2] * ins[4]) for ins in bwd
                        if ins[0] == _B_DENSE]
                       + [(ins[6], ins[4]) for ins in bwd
                          if ins[0] == _B_DENSE and ins[6] >= 0])
        ends = [0] + [o + n for o, n in spans]
        reason = None
        if any(ins[0] == _B_ANORM for ins in bwd):
            reason = ("an ActNorm layer: its gradients are row sums the "
                      "tensor-core design of train_stream does not take")
        elif [o for o, _ in spans] != ends[:-1] or ends[-1] != sp.n_params:
            reason = ("folded parameters outside the dense layers: the "
                      "tensor-core design of train_stream takes the dense "
                      "layers' gradients only")
        sp._tc["reason"] = reason
    return reason


def _bwd_instructions(words) -> list:
    """The backward program's instructions (lists of words) of a lowered
    program ``[header | forward | backward]``."""
    n_fwd, n_bwd = int(words[_H_NFWD]), int(words[_H_NBWD])
    b0 = _HEADER_WORDS + n_fwd * _INSTR_WORDS
    return [words[b0 + i * _INSTR_WORDS:b0 + (i + 1) * _INSTR_WORDS].tolist()
            for i in range(n_bwd)]


def uses_tc(sp: StepPlan, batchsize: int) -> bool:
    """The launch rule, from the plan's shape and the batch's rows: whether
    a launch takes the tensor-core design."""
    return (tc_reason(sp) is None
            and -(-batchsize // _stream_tile(sp, batchsize)) > TC_MIN_TILES
            and _tc_workspace_bytes(sp, batchsize) <= TC_WORKSPACE_BYTES)


def _tc_counts(batchsize: int):
    """``(n_tiles, n_seg)`` of the tensor-core design at ``batchsize``."""
    n_tiles = -(-batchsize // TC_ROWS)
    return n_tiles, -(-n_tiles // TC_SEG_TILES)


def tc_items(sp: StepPlan, batchsize: int) -> np.ndarray:
    """``(n_items, 4)`` int32: the weight-gradient items of the tensor-core
    design, each ``(word of its B_DENSE instruction, first input feature,
    first output column, segment)``; the largest first, so that the blocks,
    which take items k, k + grid, ..., end close together."""
    got = sp._tc.get(("items", batchsize))
    if got is not None:
        return got
    pk = sp.packed(TC_ROWS, keep_deltas=True)
    words = pk.prog.cpu().numpy()
    n_tiles, n_seg = _tc_counts(batchsize)
    n_fwd = int(words[_H_NFWD])
    items = []
    for j, ins in enumerate(_bwd_instructions(words)):
        if ins[0] != _B_DENSE:
            continue
        word = _HEADER_WORDS + (n_fwd + j) * _INSTR_WORDS
        k, n = ins[2], ins[4]
        for m0 in range(0, k, TC_ITEM):
            for n0 in range(0, n, TC_ITEM):
                area = (-(-min(TC_ITEM, k - m0) // 32)
                        * -(-min(TC_ITEM, n - n0) // 32))
                for seg in range(n_seg):
                    tiles = min(n_tiles, (seg + 1) * TC_SEG_TILES) \
                        - seg * TC_SEG_TILES
                    items.append((-area * tiles, word, m0, n0, seg))
    items.sort()
    got = np.array([i[1:] for i in items], np.int32).reshape(-1, 4)
    sp._tc["items", batchsize] = got
    return got


def stream_workspace_bytes(sp: StepPlan, batchsize: int) -> int:
    """Device memory a launch at ``batchsize`` takes besides the state and
    the partial buffer: :func:`_tc_workspace_bytes` for the tensor-core
    design, 0 for the tile body."""
    return _tc_workspace_bytes(sp, batchsize) if uses_tc(sp, batchsize) \
        else 0


def _tc_workspace_bytes(sp: StepPlan, batchsize: int) -> int:
    """The tensor-core design's workspace at ``batchsize``: every tile's
    rows, caches and cotangents (the tile layout rounded up to 16 bytes),
    the tiles' losses and the weights' two 3xTF32 planes."""
    n_tiles, _ = _tc_counts(batchsize)
    stride = _align4(sp.packed(TC_ROWS, keep_deltas=True).total_floats)
    return 4 * (n_tiles * stride + _align4(n_tiles)
                + 2 * _align4(sp.n_params))


def launch_shape(sp: StepPlan, batchsize: int, co_resident=None,
                 n_blocks=None, stage=None) -> StreamShape:
    """The :class:`StreamShape` of a launch, all in one place. The design
    by the plan's shape and the batch (``uses_tc``). The tile body: the step
    kernel's tile and threads (``StepPlan.pick_tile`` / ``threads``, at most
    ``STEP_MAX_THREADS``), the parameters staged in shared memory wherever
    they fit beside the tile (``stage`` forces it), and the grid (one block
    per tile, at most its cap). The tensor-core design: tiles of
    ``TC_ROWS`` rows, ``TC_THREADS`` threads, a block per SM (the tiles'
    count without a device), nothing staged. Either grid has at most
    ``co_resident`` blocks of its shape — a cooperative launch needs every
    block resident at once. An explicit ``n_blocks`` beyond either limit is
    refused."""
    tc = uses_tc(sp, batchsize)
    if tc:
        if stage:
            raise ValueError("train_stream: the tensor-core design stages "
                             "no parameters")
        tile, threads, shared, staged = (TC_ROWS, TC_THREADS,
                                         TC_SHARED_BYTES, False)
        n_tiles = _tc_counts(batchsize)[0]
    else:
        tile, threads, shared, staged = _stream_block(sp, batchsize, stage)
        n_tiles = -(-batchsize // tile)
    if co_resident is not None and co_resident < 1:
        raise ValueError(
            f"train_stream: no block of {threads} threads and "
            f"{shared} bytes of shared memory can be resident, or the device "
            "has no cooperative launch")
    if n_blocks is None:
        n_blocks = n_tiles if tc else sp.grid(batchsize, tile)
        if co_resident is not None:
            n_blocks = co_resident if tc else min(n_blocks, co_resident)
    if co_resident is not None and n_blocks > co_resident:
        raise ValueError(
            f"train_stream: a grid of {n_blocks} blocks, but only "
            f"{co_resident} blocks of {threads} threads and "
            f"{shared} bytes of shared memory can be resident at once")
    if n_blocks < 1 or (not tc and n_blocks > n_tiles):
        raise ValueError(
            f"train_stream: {n_blocks} blocks for {n_tiles} row tiles; every "
            "block needs a tile")
    return StreamShape(tile, threads, shared, int(n_blocks), staged, tc)


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

def _device_items(sp: StepPlan, batchsize: int, device) -> torch.Tensor:
    """:func:`tc_items` on ``device``, uploaded once per batch size."""
    key = ("device_items", batchsize, str(device))
    got = sp._tc.get(key)
    if got is None:
        got = torch.as_tensor(tc_items(sp, batchsize), device=device)
        sp._tc[key] = got
    return got


def _workspace(sp: StepPlan, batchsize: int, device) -> torch.Tensor:
    """The tensor-core design's workspace: :func:`stream_workspace_bytes`
    of float32 on ``device``."""
    return torch.empty(stream_workspace_bytes(sp, batchsize) // 4,
                       dtype=torch.float32, device=device)


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
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.df_train_stream_max_blocks.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def co_resident_blocks(threads: int, shared_bytes: int, tc=False) -> int:
    """Blocks of ``train_stream`` (``tc``: of its tensor-core design) with
    this shape that the current CUDA device can hold at once (occupancy per
    SM times the SM count; 0 where the device has no cooperative launch)."""
    out = ctypes.c_int(0)
    err = _library().df_train_stream_max_blocks(int(bool(tc)), int(threads),
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
    shape = launch_shape(sp, batchsize)
    return launch_shape(sp, batchsize, co_resident_blocks(
        shape.threads, shape.shared_bytes, shape.tc), n_blocks)


def _train_stream(launch, sp: StepPlan, tparams, mu, nu, x, theta,
                  epoch_perms, *, batchsize, count0, lr, b1, b2, eps, w,
                  guard_nonfinite, with_losses, shape, clocks=None):
    """Check the arguments, lay out the buffers on ``x``'s device and hand
    them to ``launch(ptrs, iargs, fargs, threads, shared_bytes, n_blocks) →
    error code``, the C entry point of ``csrc/stream_kernels.cu``.
    ``shape``: :func:`launch_shape`'s :class:`StreamShape`. ``clocks``: a
    float32 buffer on the device for the cycle counts of the
    ``DF_STREAM_CLOCKS`` build (the tile body's), or None."""
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
    tile, threads, shared, n_blocks, staged, tc = shape
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"train_stream needs {shared} bytes of shared "
                         f"memory (limit {MAX_SHARED_BYTES})")
    idx = pad_epoch_perms(epoch_perms, n_rows, batchsize)
    epochs, n_pad = idx.shape
    if epochs == 0:
        raise ValueError("epochs must be at least 1")
    n_batches = n_pad // batchsize
    n_tiles = -(-batchsize // tile)
    packed = sp.packed(tile, keep_deltas=tc)
    # the tensor-core design's segments of the batch, its W items and its
    # workspace; the tile body's partial rows are its blocks'
    n_seg = _tc_counts(batchsize)[1] if tc else 0
    items = _device_items(sp, batchsize, device) if tc else None
    rows = n_seg if tc else n_blocks

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
    partial = torch.empty(rows * (n_p + 1), **f32)
    ws = _workspace(sp, batchsize, device) if tc else None
    grad = torch.empty(n_p + 1, **f32)
    flags = torch.empty(n_blocks, **f32)
    snaps = torch.empty(epochs, n_p, **f32)
    skips = torch.empty(epochs, **f32)
    losses = torch.empty(epochs * n_batches if with_losses else 0, **f32)
    denoms = batch_denominators(perm, n_rows, batchsize, w)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    ptrs = (ctypes.c_void_p * 20)(
        ptr(x), ptr(theta if n_cond else None), ptr(w), ptr(perm),
        ptr(packed.flat_mask), ptr(packed.flat_consts), ptr(packed.prog),
        ptr(state[0]), ptr(state[1]), ptr(state[2]), ptr(partial), ptr(grad),
        ptr(flags), ptr(snaps), ptr(skips), ptr(losses), ptr(clocks),
        ptr(denoms), ptr(ws), ptr(items))
    iargs = (ctypes.c_int * 13)(
        epochs, n_batches, batchsize, n_rows, n_tiles, int(count0),
        int(w is not None), int(bool(guard_nonfinite)), int(staged), int(tc),
        n_seg, TC_SEG_TILES, 0 if items is None else items.shape[0])
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
    run_fused_train_stream.tc_launches += int(shape.tc)
    return out


run_fused_train_stream.launches = 0
run_fused_train_stream.tc_launches = 0
