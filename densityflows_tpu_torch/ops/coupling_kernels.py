"""Per-layer fused coupling: the CUDA kernels' wrappers, their plain
versions and the ``torch.autograd.Function`` around them.

PyTorch/CUDA counterpart of ``densityflows_tpu/ops/pallas_coupling.py``. One
RealNVP or NICE coupling on 2-D tiles: the conditioner input ``h`` (B, K =
n + |id|) goes through the s- and t-MLPs (the last dense layer linear), then
``y·eˢ + t`` (forward) or ``(y − t)·e⁻ˢ`` (inverse), NICE ``y ± t``, with
``ldj = ±Σs`` (0 for NICE). The layers of ``models/layers.py`` route here
under ``set_fused_kernels(True)`` only, as the JAX layers do.

Kernels (``csrc/coupling_kernels.cu``, built by ``_build.py`` at first use):

- :func:`coupling_fwd` launches ``coupling_fwd``; it replaces
  ``densityflows_tpu/ops/pallas_coupling.py::_fwd_kernel``.
- :func:`coupling_bwd` launches the backward's kernels; together they
  replace ``::_bwd_kernel``. Every product of the backward is a matrix
  product over all rows, computed by one hand-written register-tiled f32
  kernel (``coupling_product``), one launch per layer of the forward and per
  layer of the backward (both nets' products in one launch), with the
  coupling's pullback (``coupling_pullback``) between them. The TPU kernel
  adds each grid step's dW / db into resident output blocks, which needs its
  grid to run in order; here a dW product cuts the rows into a fixed number
  of segments and ``coupling_bwd_reduce`` sums the segments in index order
  (see the source's note). ``bwd_launches`` gives the count per call.

A wrapper uses its plain version (:func:`coupling_fwd_plain`,
:func:`coupling_bwd_plain`) only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises. The kernels are float32 only:
``fused_coupling`` upcasts bfloat16 weights and biases (conditioners stored
by ``cast_conditioners``), and any other dtype raises ``TypeError``. ``coupling_fwd.launches``,
``coupling_bwd.launches`` (the products and the pullback) and
``coupling_bwd.reduce_launches`` count kernel launches (:func:`launch_counts`).

A net is handed to the wrappers as ``(weights, biases, activation)``:
weights ``(in_i, out_i)``, biases ``(out_i,)`` or an empty list; ``None``
for NICE's absent s-net.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import chain_kernels as ck
from .chain_kernels import MAX_SHARED_BYTES
from .step_kernels import _full_f32

__all__ = [
    "fused_coupling", "fused_coupling_nvp", "fused_coupling_nice",
    "set_tile_rows", "kernels_available", "coupling_fwd",
    "coupling_bwd", "tc_plan", "tc_reason", "tc_model", "TcPlan",
    "coupling_fwd_plain", "coupling_bwd_plain", "reset_launch_counts",
    "launch_counts", "bwd_launches", "bwd_segments", "ACT_CODES",
    "TILE_ROWS", "MAX_LAYERS",
]

# activation codes of csrc/coupling_kernels.cu
ACT_CODES = {
    "identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "silu": 4, "gelu": 5,
    "softplus": 6, "elu": 7, "leaky_relu": 8,
}
# dense layers per net the kernels take
MAX_LAYERS = 16
# row tiles of coupling_fwd; it starts at its default (or the set_tile_rows
# value) and halves it until the tile's shared memory fits one block. The
# default, 8 rows, was the fastest of 8 to 64 in a sweep on an H100 at the
# opt-in train step's shapes (chip_smoke.py, phase coupling_times)
TILE_ROWS = (64, 32, 16, 8, 4, 2, 1)
_DEFAULT_TILE = {"fwd": 8}
_TILE: int | None = None
# coupling_bwd's dW products: about this many rows per segment, at most
# _MAX_SEGS segments (8192 rows: 16 segments)
_SEG_ROWS = 512
_MAX_SEGS = 32
_THREADS = 256
_KIND = {"nvp": 0, "nice": 1}
_DIRECTION = {"forward": 0, "inverse": 1}


def set_tile_rows(tb: int | None) -> None:
    """Override the rows per block of ``coupling_fwd`` (``None``: the
    defaults, 8 for the FMA body, the first of 64 / 32 / 16 that fits for
    the tensor cores, which take the value where it is one of those). A
    tile whose shared memory does not fit one block is halved all the
    same."""
    global _TILE
    if tb is not None and tb not in TILE_ROWS:
        raise ValueError(f"tile rows must be one of {TILE_ROWS}")
    _TILE = tb


def kernels_available() -> bool:
    """True where a CUDA device can run the kernels (the counterpart of
    ``pallas_available``)."""
    return torch.cuda.is_available()


# -- the plain versions ----------------------------------------------------------

_SQRT_2_OVER_PI = 0.7978845608028654


def _act(name: str, u: torch.Tensor) -> torch.Tensor:
    if name == "identity":
        return u
    if name == "relu":
        return torch.relu(u)
    if name == "tanh":
        return torch.tanh(u)
    if name == "sigmoid":
        return torch.sigmoid(u)
    if name == "silu":
        return u * torch.sigmoid(u)
    if name == "gelu":
        return F.gelu(u, approximate="tanh")
    if name == "softplus":   # logaddexp(u, 0), as jax.nn.softplus
        return torch.clamp(u, min=0) + torch.log1p(torch.exp(-u.abs()))
    if name == "elu":
        return torch.where(u > 0, u, torch.expm1(u))
    if name == "leaky_relu":
        return torch.where(u >= 0, u, 0.01 * u)
    raise ValueError(f"unsupported activation for the coupling kernels: "
                     f"{name}")


def _act_grad(name: str, u: torch.Tensor) -> torch.Tensor:
    """act'(u) as a function of the PRE-activation u."""
    if name == "identity":
        return torch.ones_like(u)
    if name == "relu":
        return (u > 0).to(u.dtype)
    if name == "tanh":
        th = torch.tanh(u)
        return 1.0 - th * th
    if name in ("sigmoid", "softplus"):
        s = torch.sigmoid(u)
        return s * (1.0 - s) if name == "sigmoid" else s
    if name == "silu":
        s = torch.sigmoid(u)
        return s * (1.0 + u * (1.0 - s))
    if name == "gelu":
        th = torch.tanh(_SQRT_2_OVER_PI * (u + 0.044715 * u * u * u))
        dinner = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * u * u)
        return 0.5 * (1.0 + th) + 0.5 * u * (1.0 - th * th) * dinner
    if name == "elu":
        return torch.where(u > 0, torch.ones_like(u), torch.exp(u))
    if name == "leaky_relu":
        return torch.where(u >= 0, torch.ones_like(u),
                           torch.full_like(u, 0.01))
    raise ValueError(f"unsupported activation for the coupling kernels: "
                     f"{name}")


def _mlp_keep(x, net):
    """(out, pre-activations, layer inputs) of one net; the last layer is
    linear."""
    ws, bs, act = net
    a, pre, acts = x, [], [x]
    for i, w in enumerate(ws):
        u = a @ w
        if bs:
            u = u + bs[i]
        pre.append(u)
        last = i == len(ws) - 1
        a = u if last else _act(act, u)
        if not last:
            acts.append(a)
    return a, pre, acts


def coupling_fwd_plain(s, t, h, y, *, direction, with_ldj):
    """Plain PyTorch version of ``coupling_fwd``: ``(y_out, ldj)`` with ldj
    (B,), or ``y_out`` alone."""
    with torch.no_grad(), _full_f32():
        t_out = _mlp_keep(h, t)[0]
        if s is None:
            out = y + t_out if direction == "forward" else y - t_out
            ldj = y.new_zeros(y.shape[0])
        else:
            s_out = _mlp_keep(h, s)[0]
            if direction == "forward":
                out, ldj = y * torch.exp(s_out) + t_out, s_out.sum(-1)
            else:
                out, ldj = (y - t_out) * torch.exp(-s_out), -s_out.sum(-1)
    return (out, ldj) if with_ldj else out


def _mlp_bwd(delta, pre, acts, net):
    """One net backward from the cotangent of its output: (cotangent of its
    input, dW list, db list)."""
    ws, bs, act = net
    n = len(ws)
    dws, dbs = [None] * n, [None] * n if bs else []
    for i in range(n - 1, -1, -1):
        dws[i] = acts[i].T @ delta
        if bs:
            dbs[i] = delta.sum(0)
        delta = delta @ ws[i].T
        if i > 0:
            delta = delta * _act_grad(act, pre[i - 1])
    return delta, dws, dbs


def coupling_bwd_plain(s, t, h, y, g_y, g_ldj, *, direction):
    """Plain PyTorch version of ``coupling_bwd``: the hand-written pullback
    of the TPU kernel (not autograd), ``(dh, dy, (dws_s, dbs_s) or None,
    (dws_t, dbs_t))``::

        forward  x = y·eˢ + t, ldj = +Σs:   dy = g·eˢ,  dt = g,
                                            ds = g·y·eˢ + g_ldj
        inverse  z = (y − t)·e⁻ˢ, ldj = −Σs: dy = g·e⁻ˢ, dt = −g·e⁻ˢ,
                                            ds = −g·z − g_ldj
        NICE: dy = g, dt = ±g.
    """
    g_ldj = g_ldj.reshape(-1, 1)
    with torch.no_grad(), _full_f32():
        t_out, t_pre, t_acts = _mlp_keep(h, t)
        if s is None:
            dy = g_y
            dt = g_y if direction == "forward" else -g_y
            dh, dws_t, dbs_t = _mlp_bwd(dt, t_pre, t_acts, t)
            return dh, dy, None, (dws_t, dbs_t)
        s_out, s_pre, s_acts = _mlp_keep(h, s)
        if direction == "forward":
            es = torch.exp(s_out)
            dy, dt = g_y * es, g_y
            ds = g_y * y * es + g_ldj
        else:
            ems = torch.exp(-s_out)
            z = (y - t_out) * ems
            dy = g_y * ems
            dt = -dy
            ds = -g_y * z - g_ldj
        dh_s, dws_s, dbs_s = _mlp_bwd(ds, s_pre, s_acts, s)
        dh_t, dws_t, dbs_t = _mlp_bwd(dt, t_pre, t_acts, t)
        return dh_s + dh_t, dy, (dws_s, dbs_s), (dws_t, dbs_t)


# -- checks and sizes ------------------------------------------------------------

def _require_f32(x, name):
    if x.dtype != torch.float32:
        raise TypeError(
            f"the per-layer coupling kernels are float32 only: {name} is "
            f"{x.dtype} (set_fused_kernels(False) selects the plain layer "
            "path)")


def _dims(net):
    ws = net[0]
    return [int(ws[0].shape[0])] + [int(w.shape[1]) for w in ws]


def _check_net(net, name, K, A, device):
    ws, bs, act = net
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation for the coupling kernels: "
                         f"{act}")
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise ValueError(f"{name}: 1 to {MAX_LAYERS} dense layers, got "
                         f"{len(ws)}")
    if bs and len(bs) != len(ws):
        raise ValueError(f"{name}: {len(ws)} weights but {len(bs)} biases")
    dims = _dims(net)
    if dims[0] != K or dims[-1] != A:
        raise ValueError(f"{name} maps {dims[0]} -> {dims[-1]}, the coupling "
                         f"needs {K} -> {A}")
    for i, w in enumerate(ws):
        _check(w, f"{name} weight {i}", (dims[i], dims[i + 1]), device)
        if bs:
            _check(bs[i], f"{name} bias {i}", (dims[i + 1],), device)


def _check(x, name, shape, device):
    if (x.dtype == torch.float32 and x.shape == tuple(shape)
            and x.device == device and x.is_contiguous()):
        return
    _require_f32(x, name)
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(s, t, h, y):
    if h.dim() != 2 or y.dim() != 2 or h.shape[0] != y.shape[0]:
        raise ValueError(f"h (B, K) and y (B, A) expected, got "
                         f"{tuple(h.shape)} and {tuple(y.shape)}")
    B, K = h.shape
    A = y.shape[1]
    _check(h, "h", (B, K), h.device)
    _check(y, "y", (B, A), h.device)
    if t is None:
        raise ValueError("the t-net is required")
    if s is not None:
        _check_net(s, "s-net", K, A, h.device)
    _check_net(t, "t-net", K, A, h.device)
    return B, K, A


def _row_floats(net):
    """The backward's workspace per row of one net: the pre-activation and
    the activation of every hidden layer, and the net's output."""
    if net is None:
        return 0
    d = _dims(net)
    return 2 * sum(d[1:-1]) + d[-1]


def fwd_shared_bytes(tile, s, t, K, A) -> int:
    hmax = max([0] + [h for net in (s, t) if net is not None
                      for h in _dims(net)[1:-1]])
    return 4 * tile * (K + 2 * hmax + 2 * A)


def bwd_segments(rows: int) -> int:
    """Row segments of the backward's dW products for a batch of ``rows``."""
    return max(1, min(_MAX_SEGS, rows // _SEG_ROWS))


def bwd_launches(s, t) -> int:
    """Launches of one ``coupling_bwd`` call besides its reduction: a product
    launch per layer of the deeper net, forward and backward, and the
    pullback."""
    return 2 * max(len(net[0]) for net in (s, t) if net is not None) + 1


def workspace_floats(rows, s, t, segs=1) -> int:
    """The backward's workspace: per row of each net, its hidden layers'
    pre-activations and activations and its output; then the dW / db
    partials of every segment (``csrc/coupling_kernels.cu::net_workspace``)."""
    return rows * (_row_floats(s) + _row_floats(t)) + segs * grad_items(s, t)


def grad_items(s, t) -> int:
    """dW / db entries, one thread each in the reduction; per segment, the
    entries of the dW products' partials."""
    items = 0
    for net in (s, t):
        if net is not None:
            d = _dims(net)
            items += sum(d[i] * d[i + 1] for i in range(len(d) - 1))
            if net[1]:
                items += sum(d[1:])
    return items


def pick_tile(which: str, need) -> int:
    """Rows per block of kernel ``which`` ("fwd"): the default (or set)
    tile, halved until ``need(tile)`` bytes fit one block; raises
    ``ValueError`` when even one row does not."""
    tb = _TILE or _DEFAULT_TILE[which]
    while tb > 1 and need(tb) > MAX_SHARED_BYTES:
        tb //= 2
    if need(tb) > MAX_SHARED_BYTES:
        raise ValueError(
            f"coupling_{which} needs {need(1)} bytes of shared memory for "
            f"one row of its tile and a block has {MAX_SHARED_BYTES}: "
            "conditioners too wide for the per-layer coupling kernels")
    return tb


# -- the tensor-core path of coupling_fwd ----------------------------------------

class TcPlan(NamedTuple):
    """``coupling_fwd``'s tensor-core path at one shape: the coupling as a
    one-coupling program of the chain kernels' format (``prog``: 8 words an
    instruction, each net's dense layers then ``OP_COUPLE``); per dense
    layer in program order ``(K, N, chunk offset, bias offset)``
    (``layout``); the workspace's bias area and weight chunks (floats; the
    chunks start after the bias area); the hidden buffers' row stride and
    the row tile (``ops/chain_kernels.py::pick_tile_rows``)."""
    prog: list
    layout: list
    bias_floats: int
    tiled_floats: int
    ldh: int
    tile_rows: int


def _chunk_floats(k4: int, n4: int) -> int:
    """Floats of one dense layer's chunks (``tile_weights``' layout)."""
    k16 = -(-k4 // ck._CHUNK_ROWS) * ck._CHUNK_ROWS
    return sum(ck._chunk_cols(n4 - c0) * k16
               for c0 in range(0, n4, ck._PASS_COLS))


def tc_plan(s, t, K, A, direction):
    """Lower one coupling for the tensor-core path, or None where its tile
    does not fit a block at any of the chain kernels' row tiles (then
    ``coupling_fwd`` runs the FMA body; :func:`tc_reason` says why)."""
    prog, layout = [], []
    bias_run = tiled_run = hmax4 = 0
    for net, dst in ((s, ck._BUF_S), (t, ck._BUF_T)):
        if net is None:
            continue
        ws, bs, act = net
        src, k4 = ck._BUF_IN, ck._up4(K)
        for i, w in enumerate(ws):
            k, n = int(w.shape[0]), int(w.shape[1])
            n4 = ck._up4(n)
            last = i == len(ws) - 1
            out = dst if last else (ck._BUF_HA if i % 2 == 0 else ck._BUF_HB)
            b_off = -1
            if bs:
                b_off, bias_run = bias_run, bias_run + n4
            prog.append([ck._OP_DENSE, src, out, k4, n4, tiled_run, b_off,
                         ck.ACT_CODES["identity" if last else act]])
            layout.append([k, n, tiled_run, b_off])
            tiled_run += _chunk_floats(k4, n4)
            if not last:
                hmax4 = max(hmax4, n4)
            src, k4 = out, n4
    prog.append([ck._OP_COUPLE, ck._KIND_NVP if s is not None
                 else ck._KIND_NICE, _DIRECTION[direction],
                 ck._float_bits(0.0), 0, 0, 0, 0])
    ldh = hmax4 + 4 if hmax4 else 0
    # the set_tile_rows value where it is one of the fold's tiles and fits,
    # else the first of them that fits
    tiles = ((_TILE,) if _TILE in ck.TILE_ROWS else ()) + ck.TILE_ROWS
    tile = next((tb for tb in tiles
                 if ck.shared_memory_bytes(tb, A, K, ldh) <= MAX_SHARED_BYTES),
                None)
    if tile is None or K < 1:
        return None
    return TcPlan(prog, layout, bias_run, tiled_run, ldh, tile)


def tc_reason(s, t, K, A):
    """Why ``coupling_fwd`` runs the FMA body at this shape, or None where
    it runs on the tensor cores."""
    if tc_plan(s, t, K, A, "forward") is not None:
        return None
    if K < 1:
        return "no conditioner input"
    hid = max([0] + [int(w.shape[1]) for net in (s, t) if net is not None
                     for w in net[0][:-1]])
    return (f"the tensor-core tile does not fit a block: K {K}, A {A}, "
            f"hidden {hid} need "
            f"{ck.shared_memory_bytes(min(ck.TILE_ROWS), A, K, ck._up4(hid) + 4)}"
            f" bytes at {min(ck.TILE_ROWS)} rows (limit {MAX_SHARED_BYTES})")


def tc_model(plan: TcPlan, s, t, K, A):
    """The tensor-core path's program as an ``ops/chain_kernels.py``
    ``PackedPlan`` on the CPU: the workspace's bias area, then each layer's
    weights row-major with both extents padded to 4 (the program's weight
    offsets moved there), so that ``packed_apply_reference`` executes it
    and ``tile_weights`` gives the chunks the tiling kernel writes."""
    mats, instrs, off = [], [], plan.bias_floats
    flat = [torch.zeros(plan.bias_floats)]
    nets = [net for net in (s, t) if net is not None]
    layers = [(w, net[1][i] if net[1] else None)
              for net in nets for i, w in enumerate(net[0])]
    bias = flat[0]
    for ins, (w, b), lay in zip(plan.prog, layers, plan.layout):
        k4, n4 = ins[3], ins[4]
        m = torch.zeros(k4, n4)
        m[:w.shape[0], :w.shape[1]] = w.detach().float().cpu()
        mats.append(m.reshape(-1))
        instrs.append(ins[:5] + [off] + ins[6:])
        off += k4 * n4
        if b is not None:
            bias[lay[3]:lay[3] + b.numel()] = b.detach().float().cpu()
    instrs.append(plan.prog[-1])
    flat = torch.cat([bias] + mats)
    hmax4 = plan.ldh - 4 if plan.ldh else 0
    return ck.PackedPlan((), A, K, hmax4,
                         torch.tensor(instrs, dtype=torch.int32), flat,
                         ck.tile_weights(flat, instrs))


class _TcLaunch(NamedTuple):
    """What a tensor-core call needs that depends on the shape only, made
    once per shape: the plan, its program on the device and the ctypes
    integer arguments."""
    plan: TcPlan
    prog: torch.Tensor
    layout: object
    iargs: object


_TC_LAUNCHES: dict = {}


def _tc_launch(s, t, direction, with_ldj, B, K, A, device):
    """The launcher of a shape, or None where the FMA body runs it."""
    key = (str(device), direction, bool(with_ldj), B, K, A, _net_key(s),
           _net_key(t), _TILE)
    if key not in _TC_LAUNCHES:
        plan = tc_plan(s, t, K, A, direction)
        _TC_LAUNCHES[key] = None if plan is None else _TcLaunch(
            plan, torch.tensor(plan.prog, dtype=torch.int32, device=device),
            (ctypes.c_int * (4 * len(plan.layout)))(
                *[v for lay in plan.layout for v in lay]),
            _iargs(s, t, direction, with_ldj, B, K, A, 0))
    return _TC_LAUNCHES[key]


def _run_fwd_tc(launch, tcl, s, t, h, y, *, with_ldj):
    """The tensor-core forward's buffers and ``launch(ptrs, iargs, layout,
    n_layers, bias_floats, tiled_floats, prog, n_instr, ldh, tile_rows) →
    error code``: the weight tiling, then the fold."""
    plan = tcl.plan
    out = torch.empty_like(y)
    ldj = torch.empty(y.shape[0], dtype=torch.float32, device=y.device) \
        if with_ldj else None
    ws = torch.empty(plan.bias_floats + plan.tiled_floats,
                     dtype=torch.float32, device=y.device)
    err = launch(_ptrs((h, y, None, None, out, ldj, None, None, ws), s, t),
                 tcl.iargs, tcl.layout, len(plan.layout), plan.bias_floats,
                 plan.tiled_floats, tcl.prog.data_ptr(), len(plan.prog),
                 plan.ldh, plan.tile_rows)
    if err != 0:
        raise RuntimeError(f"coupling_fwd launch failed (CUDA error {err})")
    return (out, ldj) if with_ldj else out


# -- the launches ----------------------------------------------------------------

def _iargs(s, t, direction, with_ldj, B, K, A, tile):
    ia = [_KIND["nvp" if s is not None else "nice"], _DIRECTION[direction],
          int(bool(with_ldj)), B, K, A, tile]
    for net in (s, t):
        if net is None:
            ia += [0, 0, 0, K]
        else:
            ia += [len(net[0]), ACT_CODES[net[2]], int(bool(net[1]))]
            ia += _dims(net)
    return (ctypes.c_int * len(ia))(*ia)


def _ptrs(head, s, t):
    """The forward's pointers in the order of ``make_args``: the head, then
    per net its weights and biases."""
    ps = [x.data_ptr() if x is not None else 0 for x in head]
    for net in (s, t):
        if net is not None:
            ps += [x.data_ptr() for x in net[0] + net[1]]
    return (ctypes.c_longlong * len(ps))(*ps)


def _check_direction(direction):
    if direction not in _DIRECTION:
        raise ValueError("direction must be 'forward' or 'inverse'")


def _run_fwd(launch, s, t, h, y, *, direction, with_ldj, tile=None):
    """Lay out the buffers on ``h``'s device and hand them to ``launch(ptrs,
    iargs, threads, shared_bytes) → error code``, the C entry point of
    ``csrc/coupling_kernels.cu``."""
    B, K, A = y.shape[0], h.shape[1], y.shape[1]
    if tile is None:
        tile = pick_tile("fwd", lambda tb: fwd_shared_bytes(tb, s, t, K, A))
    shared = fwd_shared_bytes(tile, s, t, K, A)
    out = torch.empty_like(y)
    ldj = torch.empty(B, dtype=torch.float32, device=y.device) \
        if with_ldj else None
    err = launch(_ptrs((h, y, None, None, out, ldj, None, None, None), s, t),
                 _iargs(s, t, direction, with_ldj, B, K, A, tile), _THREADS,
                 shared)
    if err != 0:
        raise RuntimeError(f"coupling_fwd launch failed (CUDA error {err})")
    return (out, ldj) if with_ldj else out


class _BwdLayout(NamedTuple):
    """The backward's arguments that depend on shapes only, made once per
    shape: the ctypes integer arguments, the workspace size and where each
    output lies in the one buffer that holds them all."""
    iargs: object
    n_ws: int
    sizes: tuple      # floats of dh, dy, then per net its dW and db
    shapes: tuple
    n_grads: tuple    # (weights, biases) per net, None for an absent net


_BWD_LAYOUTS: dict = {}


def _net_key(net):
    if net is None:
        return None
    return (tuple(tuple(w.shape) for w in net[0]), bool(net[1]), net[2])


def _bwd_layout(s, t, direction, B, K, A, segs):
    key = (direction, B, K, A, segs, _net_key(s), _net_key(t))
    layout = _BWD_LAYOUTS.get(key)
    if layout is None:
        shapes, n_grads = [(B, K), (B, A)], []
        for net in (s, t):
            if net is None:
                n_grads.append(None)
                continue
            shapes += [tuple(w.shape) for w in net[0]]
            if net[1]:
                shapes += [(int(w.shape[1]),) for w in net[0]]
            n_grads.append((len(net[0]), len(net[0]) if net[1] else 0))
        layout = _BwdLayout(
            _iargs(s, t, direction, True, B, K, A, 1),
            workspace_floats(B, s, t, segs),
            tuple(int(np.prod(sh)) for sh in shapes), tuple(shapes),
            tuple(n_grads))
        _BWD_LAYOUTS[key] = layout
    return layout


def _run_bwd(launch, s, t, h, y, g_y, g_ldj, *, direction, segs=None,
             workspace=None):
    """The backward's buffers and ``launch(ptrs, iargs, workspace_floats,
    segs) → error code``. ``segs``: row segments of the dW products (default
    :func:`bwd_segments`). The outputs are views of one new buffer, the
    workspace (``workspace_floats`` floats; one can be handed in) another."""
    B, K, A = y.shape[0], h.shape[1], y.shape[1]
    if segs is None:
        segs = bwd_segments(B)
    layout = _bwd_layout(s, t, direction, B, K, A, segs)
    f32 = dict(dtype=torch.float32, device=y.device)
    if workspace is None:
        workspace = torch.empty(layout.n_ws, **f32)
    elif workspace.numel() != layout.n_ws:
        raise ValueError("workspace of another shape")
    outs = [x if len(sh) == 1 else x.view(sh) for x, sh in zip(
        torch.empty(sum(layout.sizes), **f32).split(layout.sizes),
        layout.shapes)]
    dh, dy = outs[0], outs[1]
    ptrs = [h.data_ptr(), y.data_ptr(), g_y.data_ptr(), g_ldj.data_ptr(), 0,
            0, dh.data_ptr(), dy.data_ptr(), workspace.data_ptr()]
    grads, k = [], 2
    for net, n in zip((s, t), layout.n_grads):
        if net is None:
            grads.append(None)
            continue
        ptrs += [x.data_ptr() for x in net[0]]
        ptrs += [x.data_ptr() for x in net[1]]
        dws, dbs = outs[k:k + n[0]], outs[k + n[0]:k + n[0] + n[1]]
        k += n[0] + n[1]
        ptrs += [x.data_ptr() for x in dws + dbs]
        grads.append((dws, dbs))
    err = launch((ctypes.c_longlong * len(ptrs))(*ptrs), layout.iargs,
                 layout.n_ws, int(segs))
    if err != 0:
        raise RuntimeError(f"coupling_bwd launch failed (CUDA error {err})")
    return dh, dy, grads[0], grads[1]


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("coupling_kernels")
        P = ctypes.POINTER(ctypes.c_longlong)
        I = ctypes.POINTER(ctypes.c_int)
        i, v = ctypes.c_int, ctypes.c_void_p
        lib.df_coupling_fwd.argtypes = [P, I, i, i, v]
        lib.df_coupling_fwd.restype = i
        lib.df_coupling_bwd.argtypes = [P, I, ctypes.c_longlong, i, v]
        lib.df_coupling_bwd.restype = i
        ll = ctypes.c_longlong
        lib.df_coupling_fwd_tc.argtypes = [P, I, I, i, ll, ll, v, i, i, i, v]
        lib.df_coupling_fwd_tc.restype = i
        _LIB = lib
    return _LIB


def _require_cuda_rows(device, rows):
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if rows == 0:
        raise ValueError("empty batch: the coupling kernels need rows")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def coupling_fwd(s, t, h, y, *, direction, with_ldj=True):
    """One coupling forward: ``(y_out, ldj)`` with ldj (B,), or ``y_out``
    alone. On CUDA tensors this launches ``coupling_fwd`` on the current
    stream or raises; on CPU tensors it runs :func:`coupling_fwd_plain`."""
    _check_direction(direction)
    B, K, A = _check_inputs(s, t, h, y)
    device = h.device
    if device.type == "cpu":
        return coupling_fwd_plain(s, t, h, y, direction=direction,
                                  with_ldj=with_ldj)
    _require_cuda_rows(device, B)
    with torch.cuda.device(device):
        stream = _stream(device)
        tcl = _tc_launch(s, t, direction, with_ldj, B, K, A, device)
        if tcl is not None:
            out = _run_fwd_tc(
                lambda *a: _library().df_coupling_fwd_tc(*a, stream), tcl,
                s, t, h, y, with_ldj=with_ldj)
            coupling_fwd.tile_launches += 1
            coupling_fwd.tc_launches += 1
        else:
            out = _run_fwd(lambda *a: _library().df_coupling_fwd(*a, stream),
                           s, t, h, y, direction=direction,
                           with_ldj=with_ldj)
    coupling_fwd.launches += 1
    return out


coupling_fwd.launches = 0
coupling_fwd.tc_launches = 0
coupling_fwd.tile_launches = 0


def coupling_bwd(s, t, h, y, g_y, g_ldj, *, direction):
    """One coupling's pullback: ``(dh, dy, (dws_s, dbs_s) or None, (dws_t,
    dbs_t))``, the weight and bias gradients summed over all rows. On CUDA
    tensors this launches the backward's kernels (:func:`bwd_launches` and
    the reduction) on the current stream or raises; on CPU tensors it runs
    :func:`coupling_bwd_plain`."""
    _check_direction(direction)
    B, K, A = _check_inputs(s, t, h, y)
    _check(g_y, "g_y", (B, A), h.device)
    _check(g_ldj, "g_ldj", (B,), h.device)
    device = h.device
    if device.type == "cpu":
        return coupling_bwd_plain(s, t, h, y, g_y, g_ldj,
                                  direction=direction)
    _require_cuda_rows(device, B)
    with torch.cuda.device(device):
        stream = _stream(device)
        out = _run_bwd(lambda *a: _library().df_coupling_bwd(*a, stream),
                       s, t, h, y, g_y, g_ldj, direction=direction)
    coupling_bwd.launches += bwd_launches(s, t)
    coupling_bwd.reduce_launches += 1
    return out


coupling_bwd.launches = 0
coupling_bwd.reduce_launches = 0


def reset_launch_counts() -> None:
    coupling_fwd.launches = 0
    coupling_fwd.tc_launches = 0
    coupling_fwd.tile_launches = 0
    coupling_bwd.launches = 0
    coupling_bwd.reduce_launches = 0


def launch_counts() -> dict:
    return {"coupling_fwd": coupling_fwd.launches,
            "coupling_bwd": coupling_bwd.launches,
            "coupling_bwd_reduce": coupling_bwd.reduce_launches}


# -- the autograd Function and the public op --------------------------------------

class _Spec(NamedTuple):
    direction: str
    with_ldj: bool
    n_s: int          # s-net weights (0: NICE)
    nb_s: int         # s-net bias tensors handed in (0-width placeholders too)
    act_s: str
    n_t: int
    nb_t: int
    act_t: str


def _split(spec, params):
    """(s, t) nets from the flat parameters: weights, biases of s, then of
    t; 0-width bias placeholders make a net without bias."""
    def take(k, n, nb, act):
        ws, bs = list(params[k:k + n]), list(params[k + n:k + n + nb])
        has_bias = bool(bs) and all(b.numel() for b in bs)
        return (ws, bs if has_bias else [], act), k + n + nb

    s, k = (None, 0) if spec.n_s == 0 else take(0, spec.n_s, spec.nb_s,
                                                spec.act_s)
    t, _ = take(k, spec.n_t, spec.nb_t, spec.act_t)
    return s, t


class _FusedCoupling(torch.autograd.Function):
    """``coupling_fwd`` forward, ``coupling_bwd`` backward (the counterpart of
    the JAX ``custom_vjp``). A ``None`` ldj cotangent is the zero column; a
    0-width bias placeholder gets a 0-width gradient."""

    @staticmethod
    def forward(ctx, spec, h, y, *params):
        s, t = _split(spec, params)
        out = coupling_fwd(s, t, h, y, direction=spec.direction,
                           with_ldj=spec.with_ldj)
        ctx.spec = spec
        ctx.save_for_backward(h, y, *params)
        return out

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        h, y, *params = ctx.saved_tensors
        s, t = _split(spec, params)
        g_y = grads[0] if grads[0] is not None else torch.zeros_like(y)
        g_ldj = grads[1] if spec.with_ldj else None
        if g_ldj is None:
            g_ldj = y.new_zeros(y.shape[0])
        dh, dy, gs, gt = coupling_bwd(
            s, t, h, y, g_y.contiguous(), g_ldj.reshape(-1).contiguous(),
            direction=spec.direction)
        out = []
        for g, nb in ((gs, spec.nb_s), (gt, spec.nb_t)):
            if g is not None:
                out += list(g[0]) + (list(g[1]) if g[1] else [None] * nb)
        # 0-width bias placeholders: 0-width gradients
        out = [torch.zeros_like(p) if o is None else o
               for o, p in zip(out, params)]
        return (None, dh, dy, *out)


def _net_params(mlp):
    return list(mlp.weights), list(mlp.biases), mlp.activation


def fused_coupling(s_net, t_net, h, y_af, *, direction, with_ldj=True):
    """Fused coupling transform on 2-D tiles.

    ``h``: (B, K) conditioner input (θ ⊕ identity dims); ``y_af``: (B, A)
    the transformed features (z_af for ``direction='forward'``, x_af for
    ``'inverse'``). ``s_net=None`` selects the NICE (additive) transform.
    Returns ``(y_out, ldj)`` with ldj of shape (B,), or just ``y_out`` when
    ``with_ldj=False``. Differentiable in ``h``, ``y_af`` and every weight
    and bias; float32, with bfloat16 weights and biases upcast to it.
    """
    _check_direction(direction)
    ws_t, bs_t, act_t = _net_params(t_net)
    if s_net is not None:
        ws_s, bs_s, act_s = _net_params(s_net)
    else:
        ws_s, bs_s, act_s = [], [], "identity"
    params = ws_s + bs_s + ws_t + bs_t
    for name, x in (("h", h), ("y_af", y_af)):
        _require_f32(x, name)
    for i, p in enumerate(params):
        if p.dtype != torch.bfloat16:
            _require_f32(p, f"conditioner parameter {i}")
    # bfloat16 conditioners are upcast (differentiably) to the kernels'
    # float32, as the JAX kernels upcast them inside
    params = [p.float() for p in params]
    spec = _Spec(direction, bool(with_ldj), len(ws_s), len(bs_s), act_s,
                 len(ws_t), len(bs_t), act_t)
    return _FusedCoupling.apply(spec, h, y_af, *params)


def fused_coupling_nvp(s_net, t_net, h, y_af, *, direction, with_ldj=True):
    """RealNVP fused coupling."""
    return fused_coupling(s_net, t_net, h, y_af, direction=direction,
                          with_ldj=with_ldj)


def fused_coupling_nice(t_net, h, y_af, *, direction, with_ldj=True):
    """NICE fused coupling."""
    return fused_coupling(None, t_net, h, y_af, direction=direction,
                          with_ldj=with_ldj)
