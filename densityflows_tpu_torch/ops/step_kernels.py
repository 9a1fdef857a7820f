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
  buffers that the training loops call every step. On a CUDA device it goes
  through a launcher bound to the plan and the batch shape
  (:meth:`StepPlan.launcher`): checks, lowering, partial buffer, ctypes
  arguments and the kernel's shared-memory attribute are made once, and a
  step allocates nothing but its result. The result is a FRESH buffer on
  every call unless the caller hands one in (``out=``): a loop that keeps
  each step's loss (``data_stream.py`` stacks them at the epoch's end) must
  not pass the same ``out`` twice.
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

__all__ = ["StepPlan", "StepLaunch", "run_fused_grads", "step_grads_plain",
           "folded_nll", "TILE_ROWS", "MAX_SHARED_BYTES"]

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
# ``pick_tile`` / ``grid`` / ``threads`` above are also train_stream's launch
# rule (ops/stream_kernels.py::launch_shape). A step_grads or train_stream
# block has at most STEP_MAX_THREADS threads (the kernels' launch bound: 128
# registers a thread; the phases loop over their items)
STEP_MAX_THREADS = 512
# fewer blocks than this: the tile is halved (down to 4 rows)
_STEP_MIN_BLOCKS = 16


def _align4(floats: int) -> int:
    return (int(floats) + 3) // 4 * 4


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
        self._shapes = {}
        self._launchers = {}
        self._tc = {}        # ops/stream_kernels.py's tensor-core design

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

    def packed(self, tile: int, keep_deltas: bool = False):
        """The plan lowered for tiles of ``tile`` rows; ``keep_deltas``:
        the layout of train_stream's tensor-core design
        (``pack_train_plan``)."""
        key = (tile, bool(keep_deltas))
        pk = self._packed.get(key)
        if pk is None:
            pk = pack_train_plan(self.plan, self._templates, self.masks,
                                 self.mask_slots, self.cparams, self.d,
                                 self.n, tile, state_in_shared=False,
                                 keep_deltas=keep_deltas)
            self._packed[key] = pk
        return pk

    def shared_bytes(self, tile: int, staged: bool = False) -> int:
        """Dynamic shared memory of one block at ``tile`` rows: the tile's
        rows, caches and scratch; with ``staged`` also the folded parameters,
        the constants and the program (``csrc/step_kernels.cu``: each part
        rounded up to 16 bytes)."""
        pk = self.packed(tile)
        if not staged:
            return pk.shared_bytes
        return 4 * (_align4(pk.total_floats) + _align4(self.n_params)
                    + _align4(pk.flat_consts.numel())
                    + _align4(pk.prog.numel()))

    def stage_fits(self, tile: int) -> bool:
        """Whether the parameters fit one block's shared memory beside the
        caches of a ``tile``-row tile (the kernel's residency switch)."""
        return self.shared_bytes(tile, True) <= MAX_SHARED_BYTES

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

    def launch_shape(self, rows: int):
        """``(tile, n_blocks, staged)`` of a ``step_grads`` launch on a batch
        of ``rows``: the tile and grid of :meth:`pick_tile` / :meth:`grid`,
        the tile halved (not below 4 rows) while the batch gives fewer than
        ``_STEP_MIN_BLOCKS`` blocks; the parameters staged in shared memory
        wherever they fit beside that tile's caches, else read from device
        memory. (A sweep on an H100, ``chip_smoke.py`` phase
        ``step_tile_sweep``: at d 16 / hidden 64 staging wins at 8-row tiles
        — 0.141 against 0.190 ms at batch 1024 — and 32-row tiles in device
        memory beat 8-row tiles staged from batch 8192 on; at the BASELINE
        model 4-row tiles win at batch 64.)"""
        shape = self._shapes.get(rows)
        if shape is None:
            tile = self.pick_tile(rows)
            while tile > 4 and -(-rows // tile) < _STEP_MIN_BLOCKS:
                tile //= 2
            shape = (tile, self.grid(rows, tile), self.stage_fits(tile))
            self._shapes[rows] = shape
        return shape

    def launcher(self, rows: int, *, tile=None, n_blocks=None, stage=None):
        """The :class:`StepLaunch` of this plan for batches of ``rows`` rows
        (made once per shape and kept). ``tile`` / ``n_blocks`` / ``stage``
        override :meth:`launch_shape`; ``stage=True`` where the parameters do
        not fit raises ``ValueError``."""
        key = rows if tile is None and n_blocks is None and stage is None \
            else (rows, tile, n_blocks, stage)
        launch = self._launchers.get(key)
        if launch is None:
            launch = StepLaunch(self, rows, tile=tile, n_blocks=n_blocks,
                                stage=stage)
            self._launchers[key] = launch
        return launch

    # -- one step ------------------------------------------------------------

    def loss_and_grads(self, flat_p, x, theta, mask, *, denom=None,
                       tile=None, n_blocks=None, stage=None, out=None):
        """One batch's flat gradient and loss in ONE buffer of
        ``n_params + 1`` floats (the gradient, then the loss), so that a
        data-parallel step sums both over the ranks with one collective. On
        CUDA tensors this launches ``step_grads`` on the current stream
        through :meth:`launcher` or raises; on CPU tensors it runs
        :func:`step_grads_plain` with the same tiling.

        ``out``: where the result goes. ``None`` (the default) gives a new
        buffer on every call; a caller that passes a buffer owns it, and the
        next call with that buffer overwrites the previous step's values."""
        device = x.device
        if device.type == "cuda":
            launch = self.launcher(x.shape[0], tile=tile, n_blocks=n_blocks,
                                   stage=stage)
            if torch.cuda.current_device() == device.index:
                result = launch(_library_launch, flat_p, x, theta, mask,
                                denom=denom, out=out)
            else:
                with torch.cuda.device(device):
                    result = launch(_library_launch, flat_p, x, theta, mask,
                                    denom=denom, out=out)
            run_fused_grads.launches += 1
            return result
        if device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        if tile is None:
            tile = self.pick_tile(x.shape[0])
        loss, grads = step_grads_plain(
            self.plan, self.views(flat_p), self.masks, self.mask_slots,
            self.cparams, x, theta, mask, denom=denom, tile=tile)
        result = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        if out is not None:
            out.copy_(result)
            return out
        return result

    def grads(self, flat_p, x, theta, mask, **kw):
        """``(loss, flat gradient)`` of one batch: views of
        :meth:`loss_and_grads`'s buffer."""
        out = self.loss_and_grads(flat_p, x, theta, mask, **kw)
        return out[self.n_params], out[:self.n_params]


class StepLaunch:
    """``step_grads`` for one :class:`StepPlan` at one batch shape on one
    device: the lowering for the tile, the launch shape, the residency, the
    (grid, n_params + 1) partial buffer and the ctypes arguments, made once.
    A call checks its tensors without copying them where they are float32,
    contiguous and on the plan's device (others go through one copy each),
    fills in their pointers and launches both kernels.

    ``staged``: whether the launches stage the parameters in shared memory
    (else the phases read them from device memory)."""

    def __init__(self, sp: StepPlan, rows: int, *, tile=None, n_blocks=None,
                 stage=None):
        if rows <= 0:
            raise ValueError("empty batch")
        auto_tile, _, auto_stage = sp.launch_shape(rows)
        if tile is None:
            tile = auto_tile
        tile = int(tile)
        if stage is None:
            stage = auto_stage if tile == auto_tile else sp.stage_fits(tile)
        if stage and not sp.stage_fits(tile):
            raise ValueError(
                f"step_grads: {sp.shared_bytes(tile, True)} bytes of shared "
                f"memory to stage the parameters at a tile of {tile} rows "
                f"(limit {MAX_SHARED_BYTES})")
        packed = sp.packed(tile)
        if packed.shared_bytes > MAX_SHARED_BYTES:
            raise ValueError(
                f"step_grads needs {packed.shared_bytes} bytes of shared "
                f"memory at a tile of {tile} rows (limit {MAX_SHARED_BYTES})")
        n_tiles = -(-rows // tile)
        if n_blocks is None:
            n_blocks = sp.grid(rows, tile)
        if not 1 <= n_blocks <= n_tiles:
            raise ValueError("n_blocks must lie between 1 and the tile count")
        self.sp, self.rows, self.tile = sp, int(rows), tile
        self.n_blocks, self.staged = int(n_blocks), bool(stage)
        self.threads = min(STEP_MAX_THREADS, sp.threads(tile))
        self.shared_bytes = sp.shared_bytes(tile, self.staged)
        self.device = sp.device
        self.packed = packed
        self.partial = torch.empty(self.n_blocks * (sp.n_params + 1),
                                   dtype=torch.float32, device=self.device)
        consts = packed.flat_consts
        self.ptrs = (ctypes.c_void_p * 10)(
            None, None, None, None, None, packed.flat_mask.data_ptr(),
            consts.data_ptr() if consts.numel() else None,
            packed.prog.data_ptr(), self.partial.data_ptr(), None)
        self.iargs = (ctypes.c_int * 5)(self.rows, n_tiles, sp.n_params, 3,
                                        int(self.staged))
        self._phases = 3
        self._x_shape = torch.Size((self.rows, sp.d))
        self._th_shape = torch.Size((self.rows, sp.n))
        self._m_shape = torch.Size((self.rows,))
        self._p_shape = torch.Size((sp.n_params,))
        self._out_shape = torch.Size((sp.n_params + 1,))

    def _ready(self, t, shape):
        """A tensor the kernel can take as it is: float32, contiguous, on
        the plan's device, of ``shape``."""
        return (t.dtype == torch.float32 and t.shape == shape
                and t.is_contiguous() and t.device == self.device)

    def __call__(self, launch, flat_p, x, theta, mask, *, denom=None,
                 out=None, phases=3):
        """Launch on ``(flat_p, x, theta, mask)`` through ``launch(ptrs,
        iargs, threads, shared_bytes, n_blocks) → error code`` (the C entry
        point of ``csrc/step_kernels.cu`` on the current stream, or its host
        emulation). Returns ``out`` (a new buffer when ``None``).

        ``phases``: 3 runs both kernels; 1 the tile kernel alone (``out`` is
        then not written), 2 the reduction alone over the partial buffer an
        earlier call left: for timing the two apart."""
        sp = self.sp
        n_cond = theta.shape[-1] if theta is not None else 0
        if mask.dim() != 1:
            mask = mask.reshape(-1)
        if not (self._ready(x, self._x_shape) and n_cond == sp.n
                and (not n_cond or self._ready(theta, self._th_shape))
                and self._ready(mask, self._m_shape)
                and self._ready(flat_p, self._p_shape)):
            x, theta, mask, flat_p = self._checked(x, theta, mask, flat_p,
                                                   n_cond)
        if denom is None:
            denom = mask.sum()
        elif not (isinstance(denom, torch.Tensor) and denom.numel() == 1
                  and denom.dtype == torch.float32
                  and denom.device == self.device):
            denom = torch.as_tensor(denom, dtype=torch.float32,
                                    device=self.device).reshape(1)
        if out is None:
            out = torch.empty(self._p_shape[0] + 1, dtype=torch.float32,
                              device=self.device)
        elif not self._ready(out, self._out_shape):
            raise ValueError(f"out must be a contiguous float32 buffer of "
                             f"{sp.n_params + 1} entries on {self.device}")
        p = self.ptrs
        p[0] = x.data_ptr()
        p[1] = theta.data_ptr() if n_cond else None
        p[2] = mask.data_ptr()
        p[3] = denom.data_ptr()
        p[4] = flat_p.data_ptr()
        p[9] = out.data_ptr()
        if phases != self._phases:
            self.iargs[3] = self._phases = int(phases)
        err = launch(p, self.iargs, self.threads, self.shared_bytes,
                     self.n_blocks)
        if err != 0:
            raise RuntimeError(f"step_grads launch failed (CUDA error {err})")
        return out

    def _checked(self, x, theta, mask, flat_p, n_cond):
        """The arguments' checks with their messages, and one copy of each
        tensor that is not float32 and contiguous."""
        sp = self.sp
        if x.dim() != 2 or x.shape[1] != sp.d or n_cond != sp.n:
            raise ValueError(
                f"plan was lowered for d {sp.d}, n {sp.n}; got x "
                f"{tuple(x.shape)}, n {n_cond}")
        if x.shape[0] != self.rows:
            raise ValueError(f"launcher made for {self.rows} rows, got "
                             f"{x.shape[0]}")
        if x.device != self.device:
            raise ValueError(
                f"plan parameters are on {self.device}, data on {x.device}")
        x = _device_f32(x, "x", self._x_shape, self.device)
        if n_cond:
            theta = _device_f32(theta, "theta", self._th_shape, self.device)
        mask = _device_f32(mask, "mask", self._m_shape, self.device)
        flat_p = _device_f32(flat_p, "parameters", self._p_shape,
                             self.device)
        return x, theta, mask, flat_p


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


def _library_launch(ptrs, iargs, threads, shared_bytes, n_blocks):
    """``df_step_grads`` on the current stream of the current device."""
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    return _library().df_step_grads(ptrs, iargs, threads, shared_bytes,
                                    n_blocks, stream)


def _step_grads(launch, sp: StepPlan, flat_p, x, theta, mask, *, denom=None,
                tile=None, n_blocks=None, stage=None, phases=3, out=None):
    """One launch through ``launch(ptrs, iargs, threads, shared_bytes,
    n_blocks) → error code``: :meth:`StepPlan.launcher` for ``x``'s row
    count, then :class:`StepLaunch`'s call (``phases`` as there). Returns
    the ``n_params + 1`` result buffer: the gradient, then the loss."""
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    step = sp.launcher(x.shape[0], tile=tile, n_blocks=n_blocks, stage=stage)
    return step(launch, flat_p, x, theta, mask, denom=denom, out=out,
                phases=phases)


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
