"""One batch's loss and folded-parameter gradients: the ``step_grads`` CUDA
kernel's wrapper and its plain PyTorch version.

PyTorch/CUDA counterpart of ``densityflows_tpu/ops/pallas_step.py``. The
whole-run kernel (``ops/train_kernels.py``) keeps Adam inside the kernel,
which is right on one device, but a data-parallel step needs the sum of the
gradients over the ranks BETWEEN the backward pass and the update. This
kernel stops at the gradients: per tile of rows the inverse fold with
activation caches, the tile's share of the masked NLL and the hand-derived
backward, summed over the tiles in a fixed order. The streaming trainer
(``data_stream.py``) and the data-parallel step (``train.py``) run Adam on the
folded parameters outside it, in plain tensor operations.

The loss normalization ``denom = Σ mask`` spans the GLOBAL batch: a caller
that holds one shard of a batch passes the all-reduced denominator in, every
tile contributes ``−Σ m·lp / denom`` and the cotangents scale the same way,
so the sum of the shards' losses and gradients equals the whole batch's.

Plans, folded tensors, 0/1 gradient masks and constants are those of
``ops/train_kernels.py`` (built by ``models/fused_train.chain_train_fold``).

- :func:`step_grads_plain` — plain PyTorch, the same hand-derived backward,
  tile by tile or the whole batch at once. The reference of the kernel.
- :class:`StepPlan` — a plan lowered for the kernel once (per row tile), with
  the flat parameter layout; ``StepPlan.loss_and_grads`` is the launch on flat
  buffers that the training loops call every step.
- :func:`run_fused_grads` — the wrapper on lists of folded tensors. On CUDA
  tensors it launches ``step_grads`` (``csrc/step_kernels.cu``; it replaces
  ``densityflows_tpu/ops/pallas_step.py::_step_kernel``) or raises; on CPU
  tensors it runs :func:`step_grads_plain`. ``run_fused_grads.launches``
  counts kernel launches, wherever they were made from.
- :func:`folded_nll` — the masked NLL on folded tensors without gradients
  (plain PyTorch), for the per-epoch evaluations of loops that keep their
  parameters folded.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from .chain_kernels import MAX_SHARED_BYTES
from .train_kernels import (
    _device_f32,
    _folded_log_prob,
    _group,
    _log_prob,
    _plan_bwd,
    _plan_fwd,
    pack_train_plan,
)

__all__ = ["StepPlan", "run_fused_grads", "step_grads_plain", "folded_nll",
           "TILE_ROWS", "MAX_SHARED_BYTES"]

# Row tiles the wrapper chooses from; 8 and up are its own choices, the
# smaller ones only where a wider tile's caches do not fit one block. The
# choice below was held against a sweep of tiles and grids on an H100
# (``chip_smoke.py``, phase ``step_tile_sweep``: batches 64 to 65,536, hidden
# 16 and 64): it is within a tenth of the best tiling there at every batch.
TILE_ROWS = (64, 32, 16, 8, 4, 2, 1)
_PREFERRED_MIN_TILE = 8
# a batch is cut into about this many tiles (one per SM of the card) before
# the tile grows: 8-row tiles are the fastest up to batch 1024, 32-row tiles
# from batch 8192 on
_TARGET_TILES = 128
# blocks of one launch (4 per SM), each with its own gradient partial; beyond
# it a block takes several tiles in turn, which cost nothing in the sweep
_MAX_BLOCKS = 528
_MAX_THREADS = 1024


@contextlib.contextmanager
def _full_f32():
    """Float32 products in full precision (TF32 off) for the plain versions."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _denominator(mask, denom):
    if denom is None:
        denom = mask.sum()
    denom = torch.as_tensor(denom, dtype=torch.float32, device=mask.device)
    return torch.clamp(denom, min=1e-12).reshape(())


def step_grads_plain(plan, tparams, masks, mask_slots, cparams, x, theta,
                     mask, *, denom=None, tile=None):
    """Plain PyTorch version of ``step_grads``: ``(loss, grads)`` of one
    batch, the gradients aligned with ``tparams`` and already select-masked.

    ``mask``: (rows,) row weights (zeros on padded rows; importance weights
    folded in). ``denom``: the global ``Σ mask`` when this batch is one shard
    of a larger one (default: this batch's own). ``tile``: rows per pass, as
    the kernel tiles them (default: the whole batch at once)."""
    rows = x.shape[0]
    th = theta if theta is not None and theta.shape[-1] else None
    t_groups, c_groups = _group(plan, tparams, cparams)
    tile = rows if not tile else int(tile)
    with torch.no_grad(), _full_f32():
        den = _denominator(mask, denom)
        loss = x.new_zeros(())
        grads = [torch.zeros_like(p) for p in tparams]
        for r0 in range(0, max(rows, 1), max(tile, 1)):
            sl = slice(r0, r0 + tile)
            m = mask[sl].reshape(-1, 1)
            th_t = th[sl] if th is not None else None
            z, ldj, caches = _plan_fwd(plan, t_groups, c_groups, x[sl], th_t,
                                       True)
            lp = _log_prob(z, ldj)
            loss = loss - (lp * m).sum() / den
            jbar = -m / den
            g_t = _plan_bwd(plan, t_groups, caches, th_t, -jbar * z, jbar)
            grads = [g + gt for g, gt in zip(grads, g_t)]
        # the 0/1 masks as a select: inf · 0 would be NaN
        grads = [g if slot is None else
                 torch.where(masks[slot] > 0.5, g, torch.zeros_like(g))
                 for g, slot in zip(grads, mask_slots)]
    return loss, grads


def folded_nll(tparams, cparams, x, theta, mask, *, plan):
    """Masked NLL ``−Σ m·lp / max(Σ m, 1e-12)`` on FOLDED tensors, without
    gradients: plain PyTorch, the inverse fold of ``ops/train_kernels.py``.
    The per-epoch evaluation of loops that keep their parameters folded."""
    with torch.no_grad(), _full_f32():
        lp = _folded_log_prob(plan, list(tparams), list(cparams), x, theta)
        m = mask.reshape(-1)
        return -(lp * m).sum() / torch.clamp(m.sum(), min=1e-12)


class StepPlan:
    """A training plan lowered for ``step_grads``, and the flat layout of its
    folded tensors.

    Parameters and gradients are flat float32 buffers of ``n_params``
    entries in the order of the folded tensors (row-major, no padding), so
    that the update of a training loop is one pass over one buffer. The
    lowering depends on the row tile; it is made once per tile and kept.
    ``shared_bytes(tile)`` is the exact dynamic shared memory of one block."""

    def __init__(self, plan, tparams, masks, mask_slots, cparams, d: int,
                 n: int, tcounts=None):
        self.plan = tuple(plan)
        if tcounts is not None and sum(tcounts) != len(tparams):
            raise ValueError(
                f"tcounts name {sum(tcounts)} folded tensors, got "
                f"{len(tparams)}")
        _group(self.plan, tparams, cparams)     # the counts must match
        self.d, self.n = int(d), int(n)
        self.masks, self.mask_slots = list(masks), tuple(mask_slots)
        self.cparams = list(cparams)
        self.device = tparams[0].device
        self.shapes = [tuple(int(s) for s in p.shape) for p in tparams]
        self.offsets, o = [], 0
        for s in self.shapes:
            self.offsets.append(o)
            o += int(np.prod(s))
        self.n_params = o
        self._templates = [p.detach() for p in tparams]
        self._packed = {}
        self._tiles = {}

    # -- the flat layout --------------------------------------------------

    def flatten(self, tensors) -> torch.Tensor:
        tensors = list(tensors)
        if [tuple(t.shape) for t in tensors] != self.shapes:
            raise ValueError("folded tensors do not match the plan's shapes")
        return torch.cat([t.reshape(-1) for t in tensors]).contiguous()

    def views(self, flat) -> list:
        """The folded tensors as views of a flat buffer."""
        return [flat[o:o + int(np.prod(s))].view(s)
                for o, s in zip(self.offsets, self.shapes)]

    def unflatten(self, flat) -> list:
        return [v.clone() for v in self.views(flat)]

    # -- the lowering -------------------------------------------------------

    def packed(self, tile: int):
        pk = self._packed.get(tile)
        if pk is None:
            pk = pack_train_plan(self.plan, self._templates, self.masks,
                                 self.mask_slots, self.cparams, self.d,
                                 self.n, tile, state_in_shared=False)
            self._packed[tile] = pk
        return pk

    def shared_bytes(self, tile: int) -> int:
        return self.packed(tile).shared_bytes

    def min_tile(self) -> int:
        """The smallest tile; raises ``ValueError`` when even its caches
        exceed one block's shared memory."""
        need = self.shared_bytes(TILE_ROWS[-1])
        if need > MAX_SHARED_BYTES:
            raise ValueError(
                f"step_grads needs {need} bytes of shared memory for the "
                f"activation caches of a tile of {TILE_ROWS[-1]} row(s) and "
                f"a block has {MAX_SHARED_BYTES}: conditioners too deep or "
                "too wide for the step kernel")
        return TILE_ROWS[-1]

    def pick_tile(self, rows: int) -> int:
        """Rows per block for a batch of ``rows``: the widest tile that still
        cuts the batch into about one tile per SM, at least 8 rows, narrower
        only where the caches of 8 rows do not fit one block."""
        tile = self._tiles.get(rows)
        if tile is None:
            self.min_tile()
            tile = next((t for t in TILE_ROWS if t >= _PREFERRED_MIN_TILE
                         and -(-rows // t) >= _TARGET_TILES),
                        _PREFERRED_MIN_TILE)
            while self.shared_bytes(tile) > MAX_SHARED_BYTES:
                tile //= 2
            self._tiles[rows] = tile
        return tile

    def grid(self, rows: int, tile: int) -> int:
        """Thread blocks for a batch: one per tile, at most ``_MAX_BLOCKS``
        (each then takes several tiles in turn)."""
        return min(max(1, -(-rows // tile)), _MAX_BLOCKS)

    def threads(self, tile: int) -> int:
        """One thread per element of the widest per-tile array, in whole
        warps, between 128 and 1024."""
        pk = self.packed(tile)
        work = tile * max(pk.hmax, self.d)
        return int(min(_MAX_THREADS, max(128, (work + 31) // 32 * 32)))

    # -- one step ------------------------------------------------------------

    def loss_and_grads(self, flat_p, x, theta, mask, *, denom=None,
                       tile=None, n_blocks=None):
        """One batch's flat gradient and loss in ONE buffer of
        ``n_params + 1`` floats (the gradient, then the loss), so that a
        data-parallel step sums both over the ranks with one collective. On
        CUDA tensors this launches ``step_grads`` on the current stream or
        raises; on CPU tensors it runs :func:`step_grads_plain` with the
        same tiling."""
        device = x.device
        if device.type == "cuda":
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream().cuda_stream
                out = _step_grads(
                    lambda *a: _library().df_step_grads(*a, stream), self,
                    flat_p, x, theta, mask, denom=denom, tile=tile,
                    n_blocks=n_blocks)
            run_fused_grads.launches += 1
            return out
        if device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        if tile is None:
            tile = self.pick_tile(x.shape[0])
        loss, grads = step_grads_plain(
            self.plan, self.views(flat_p), self.masks, self.mask_slots,
            self.cparams, x, theta, mask, denom=denom, tile=tile)
        return torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])

    def grads(self, flat_p, x, theta, mask, **kw):
        """``(loss, flat gradient)`` of one batch: views of
        :meth:`loss_and_grads`'s buffer."""
        out = self.loss_and_grads(flat_p, x, theta, mask, **kw)
        return out[self.n_params], out[:self.n_params]


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("step_kernels")
        lib.df_step_grads.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.df_step_grads.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _step_grads(launch, sp: StepPlan, flat_p, x, theta, mask, *, denom=None,
                tile=None, n_blocks=None, phases=3, partial=None):
    """Check the arguments, lay out the buffers on ``x``'s device and hand
    them to ``launch(ptrs, iargs, threads, shared_bytes, n_blocks) → error
    code``, the C entry point of ``csrc/step_kernels.cu``. Returns the
    ``n_params + 1`` result buffer: the gradient, then the loss.

    ``phases`` / ``partial`` exist to time the two kernels apart: ``phases``
    1 runs the tile kernel only (the result buffer is then not written), 2
    the reduction only, over a ``partial`` buffer that an earlier launch with
    the same tiling filled."""
    device = x.device
    rows, d = x.shape
    n_cond = theta.shape[-1] if theta is not None else 0
    if d != sp.d or n_cond != sp.n:
        raise ValueError(
            f"plan was lowered for d {sp.d}, n {sp.n}; got d {d}, n {n_cond}")
    if rows == 0:
        raise ValueError("empty batch")
    if sp.device != device:
        raise ValueError(
            f"plan parameters are on {sp.device}, data on {device}")
    if tile is None:
        tile = sp.pick_tile(rows)
    packed = sp.packed(int(tile))
    if packed.shared_bytes > MAX_SHARED_BYTES:
        raise ValueError(
            f"step_grads needs {packed.shared_bytes} bytes of shared memory "
            f"at a tile of {tile} rows (limit {MAX_SHARED_BYTES})")
    n_tiles = -(-rows // tile)
    if n_blocks is None:
        n_blocks = sp.grid(rows, tile)
    if not 1 <= n_blocks <= n_tiles:
        raise ValueError("n_blocks must lie between 1 and the tile count")

    x = _device_f32(x, "x", (rows, d), device)
    if n_cond:
        theta = _device_f32(theta, "theta", (rows, n_cond), device)
    mask = _device_f32(mask.reshape(-1), "mask", (rows,), device)
    flat_p = _device_f32(flat_p, "parameters", (sp.n_params,), device)
    if denom is None:
        denom = mask.sum()
    denom = torch.as_tensor(denom, dtype=torch.float32,
                            device=device).reshape(1)
    f32 = dict(dtype=torch.float32, device=device)
    if partial is None:
        partial = torch.empty(n_blocks * (sp.n_params + 1), **f32)
    elif partial.numel() != n_blocks * (sp.n_params + 1):
        raise ValueError("partial buffer of another tiling")
    out = torch.empty(sp.n_params + 1, **f32)
    ptrs = (ctypes.c_void_p * 10)(
        x.data_ptr(), theta.data_ptr() if n_cond else None, mask.data_ptr(),
        denom.data_ptr(), flat_p.data_ptr(), packed.flat_mask.data_ptr(),
        packed.flat_consts.data_ptr() if packed.flat_consts.numel() else None,
        packed.prog.data_ptr(), partial.data_ptr(), out.data_ptr())
    iargs = (ctypes.c_int * 4)(rows, n_tiles, sp.n_params, int(phases))
    err = launch(ptrs, iargs, sp.threads(tile), packed.shared_bytes,
                 int(n_blocks))
    if err != 0:
        raise RuntimeError(f"step_grads launch failed (CUDA error {err})")
    return out


def run_fused_grads(x, theta, mask, tparams, masks, cparams, *, plan,
                    tcounts=None, mask_slots, denom=None, tile=None):
    """Masked-NLL loss and folded-parameter gradients of ONE batch.

    ``mask``: per-row weights (zeros for padded rows; importance weights
    fold in as in ``train.masked_nll_loss``). Returns ``(loss, grads)`` with
    ``grads`` aligned to the folded ``tparams`` and select-masked. A rank of
    a data-parallel step passes its LOCAL shard and the GLOBAL ``denom`` (the
    all-reduced ``Σ mask``): the summed losses and gradients of the ranks
    then equal the single-device values.

    On CUDA tensors this launches the ``step_grads`` kernel or raises; on
    CPU tensors it runs :func:`step_grads_plain`. The plan is lowered here on
    every call; a training loop lowers it once (:class:`StepPlan`) and calls
    ``StepPlan.loss_and_grads`` on flat buffers."""
    tparams = list(tparams)
    n_cond = theta.shape[-1] if theta is not None else 0
    sp = StepPlan(plan, tparams, masks, mask_slots, cparams, x.shape[-1],
                  n_cond, tcounts)
    loss, flat_g = sp.grads(sp.flatten(tparams), x, theta, mask, denom=denom,
                            tile=tile)
    return loss, sp.unflatten(flat_g)


run_fused_grads.launches = 0
