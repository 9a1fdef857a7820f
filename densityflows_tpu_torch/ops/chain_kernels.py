"""Whole-chain fold: the CUDA kernels' wrappers and their plain versions.

PyTorch/CUDA counterpart of ``densityflows_tpu/ops/pallas_chain.py``. The
module is layer-agnostic: it executes a *plan* — a static tuple of op
descriptors — against a flat list of parameter tensors. The plan is built
from a ``FlowChain`` by ``models/fused_chain.py``. The plan format and op
codes are those of the JAX package:

- ``("coupling", kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t,
  has_th, has_id, clamp)`` — affine coupling, kind ``"nvp"`` / ``"nice"`` /
  ``"joint"``. The feature split/recombine is folded into the conditioner
  weights: the first dense layer is pre-split into a θ part (n, H) and a
  zero-padded x part (d, H); the last dense layer is scattered to d columns
  so the nets emit d-wide ``s_full`` / ``t_full`` that are exactly zero on
  identity dims. Params per net: first-layer weights (1 or 2), hidden
  weights, folded final weight, then the biases when present. ``"joint"``
  runs one shared stack whose activations hit two folded (H, d) heads.
- ``("affine",)`` — ``x·a + b`` with constant ldj. Params ``a`` (1, d),
  ``b`` (1, d), ``c`` (1, 1).
- ``("linear",)`` — ``x @ A`` with constant ldj. Params ``A`` (d, d),
  ``c`` (1, 1).
- ``("logit", dirn, eps)`` — smooth box bijection. Params ``lo``, ``hi``,
  ``wlog`` = log(hi − lo), each (1, d).

Kernels (``csrc/chain_kernels.cu``, built by ``_build.py`` at first use):

- ``run_chain`` launches ``chain_apply``; it replaces
  ``densityflows_tpu/ops/pallas_chain.py::_chain_kernel``.
- ``run_chain_sample`` launches ``chain_sample``; it replaces
  ``densityflows_tpu/ops/pallas_chain.py::_sample_kernel``. The base draw is
  a counter-based Philox4x32-10 inside the kernel, keyed by a 64-bit seed
  taken from the caller's ``torch.Generator``; a draw depends on (seed,
  global row, column) only, the global row being ``row_offset`` plus the
  launch's row, so a rank of a mesh draws its rows of the one-launch
  draw. The stream differs from ``torch.randn``'s and from the TPU's.

Both are bound by arithmetic on an H100 (a few MFLOP of conditioner products
per row against a few hundred bytes of I/O). Their products run on the
tensor cores in 3xTF32 (``wgmma`` in the kernel's own body), with f32
accuracy; the weights stream from L2 in the tiled layout of
:func:`tile_weights`; the row tile's activations stay in shared memory.

A wrapper uses the plain version (``chain_apply_plain`` /
``chain_sample_plain``) only for a tensor that lies on the CPU. For a CUDA
tensor it launches the kernel or raises. ``run_chain.launches`` and
``run_chain_sample.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import struct

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "op_param_count", "coupling_param_count", "PackedPlan", "pack_plan",
    "packed_apply_reference", "shared_memory_bytes", "pick_tile_rows",
    "chain_apply_plain", "chain_sample_plain", "run_chain",
    "run_chain_sample", "philox_normal_reference", "reset_launch_counts",
    "launch_counts", "ACT_CODES", "MAX_SHARED_BYTES", "TILE_ROWS",
]

ACT_CODES = {
    "identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "silu": 4, "gelu": 5,
    "softplus": 6, "elu": 7, "leaky_relu": 8,
}

# program opcodes / buffer ids of csrc/chain_kernels.cu
_OP_DENSE, _OP_COUPLE, _OP_AFFINE, _OP_COMMIT, _OP_LOGIT = range(5)
_BUF_IN, _BUF_HA, _BUF_HB, _BUF_S, _BUF_T, _BUF_X = range(6)
_KIND_NVP, _KIND_NICE = 0, 1
_DIRN = {"fwd": 0, "inv": 1}
_INSTR_WORDS = 8

# shared memory a block can have on sm_90 (227 KB) and the row-tile sizes
# the kernels are instantiated for
MAX_SHARED_BYTES = 232448
TILE_ROWS = (64, 32, 16)
# the kernels' weight stream: four slots of a chunk and its remainders,
# each of at most 256 columns x 16 rows, then 12 mbarriers
_RING_FLOATS = 4 * 2 * 256 * 16 + 24


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
    if name == "softplus":
        return F.softplus(u)
    if name == "elu":
        return torch.where(u > 0, u, torch.expm1(u))
    if name == "leaky_relu":
        return torch.where(u >= 0, u, 0.01 * u)
    raise ValueError(f"unsupported activation for the chain kernels: {name}")


# -- plan bookkeeping (same counts as the JAX package) ------------------------

def _net_param_count(n_layers, has_bias, has_th, has_id) -> int:
    w = (1 if has_th else 0) + (1 if has_id else 0) + (n_layers - 1)
    return w + (n_layers if has_bias else 0)


def coupling_param_count(op) -> int:
    (_, kind, _, n_s, n_t, _, _, bias_s, bias_t, has_th, has_id, _clamp) = op
    if kind == "joint":
        w = (1 if has_th else 0) + (1 if has_id else 0) + (n_s - 2) + 2
        return w + ((n_s + 1) if bias_s else 0)
    c = _net_param_count(n_t, bias_t, has_th, has_id)
    if kind == "nvp":
        c += _net_param_count(n_s, bias_s, has_th, has_id)
    return c


def op_param_count(op) -> int:
    tag = op[0]
    if tag == "coupling":
        return coupling_param_count(op)
    if tag == "affine":
        return 3
    if tag == "linear":
        return 2
    if tag == "logit":
        return 3
    raise ValueError(f"unknown chain op {tag!r}")


def _split_params(plan, params):
    out, i = [], 0
    for op in plan:
        c = op_param_count(op)
        out.append(params[i:i + c])
        i += c
    if i != len(params):
        raise ValueError(
            f"plan consumes {i} parameter tensors, got {len(params)}")
    return out


def _net_slices(prefs, k, n_layers, has_bias, has_th, has_id):
    n_w = (1 if has_th else 0) + (1 if has_id else 0) + (n_layers - 1)
    ws = prefs[k:k + n_w]
    k += n_w
    bs = prefs[k:k + n_layers] if has_bias else [None] * n_layers
    k += n_layers if has_bias else 0
    return ws, bs, k


# -- plain PyTorch versions -----------------------------------------------------

def _first_layer(x, th, ws, has_th, has_id):
    i, u = 0, None
    if has_th:
        u = th @ ws[i]
        i += 1
    if has_id:
        ux = x @ ws[i]
        u = ux if u is None else u + ux
        i += 1
    return u, i


def _folded_mlp(x, th, ws, bs, act, n_layers, has_th, has_id):
    """Conditioner with the split first layer and the folded final layer;
    the final layer is linear."""
    u, i = _first_layer(x, th, ws, has_th, has_id)
    if bs[0] is not None:
        u = u + bs[0]
    for layer in range(1, n_layers):
        u = _act(act, u) @ ws[i]
        i += 1
        if bs[layer] is not None:
            u = u + bs[layer]
    return u


def _joint_mlp(x, th, prefs, op):
    """Two-headed conditioner: one shared stack, two folded (H, d) heads."""
    (_, _, _, n_layers, _, act, _, has_bias, _, has_th, has_id, _clamp) = op
    n_w = (1 if has_th else 0) + (1 if has_id else 0) + (n_layers - 2) + 2
    ws = prefs[:n_w]
    bs = prefs[n_w:] if has_bias else []
    u, i = _first_layer(x, th, ws, has_th, has_id)
    if has_bias:
        u = u + bs[0]
    a = _act(act, u)
    for layer in range(1, n_layers - 1):
        u = a @ ws[i]
        i += 1
        if has_bias:
            u = u + bs[layer]
        a = _act(act, u)
    s_full = a @ ws[i]
    t_full = a @ ws[i + 1]
    if has_bias:
        s_full = s_full + bs[n_layers - 1]
        t_full = t_full + bs[n_layers]
    return s_full, t_full


def _apply_coupling(op, prefs, x, th, ldj):
    (_, kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th, has_id,
     clamp) = op
    k = 0
    if kind == "joint":
        s_full, t_full = _joint_mlp(x, th, prefs, op)
    else:
        if kind == "nvp":
            ws, bs, k = _net_slices(prefs, k, n_s, bias_s, has_th, has_id)
            s_full = _folded_mlp(x, th, ws, bs, act_s, n_s, has_th, has_id)
        wt, bt, k = _net_slices(prefs, k, n_t, bias_t, has_th, has_id)
        t_full = _folded_mlp(x, th, wt, bt, act_t, n_t, has_th, has_id)
    if kind in ("nvp", "joint"):
        if clamp:
            s_full = clamp * torch.tanh(s_full / clamp)
        if dirn == "fwd":
            x = x * torch.exp(s_full) + t_full
            if ldj is not None:
                ldj = ldj + s_full.sum(-1)
        else:
            x = (x - t_full) * torch.exp(-s_full)
            if ldj is not None:
                ldj = ldj - s_full.sum(-1)
    else:
        x = x + t_full if dirn == "fwd" else x - t_full
    return x, ldj


def _apply_logit(op, prefs, x, ldj):
    _, dirn, eps = op
    lo, hi, wlog = prefs
    if dirn == "fwd":
        z = x
        x = lo + (hi - lo) * torch.sigmoid(z)
    else:
        u = ((x - lo) / (hi - lo)).clamp(eps, 1.0 - eps)
        z = torch.log(u) - torch.log1p(-u)
        x = z
    if ldj is not None:
        row = (-F.softplus(-z) - F.softplus(z) + wlog).sum(-1)
        ldj = ldj + row if dirn == "fwd" else ldj - row
    return x, ldj


def chain_apply_plain(plan, params, x, theta, *, with_ldj):
    """Plain PyTorch version of ``chain_apply``: fold ``x`` (B, d) through the
    plan. ``theta``: (B, n) or None. Returns ``(y, ldj)`` with ldj (B,), or
    ``y`` alone. Float32 matrix products run in full f32: TF32 is switched
    off for the duration of the call."""
    th = theta if theta is not None and theta.shape[-1] else None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ldj = x.new_zeros(x.shape[0]) if with_ldj else None
        for op, prefs in zip(plan, _split_params(plan, params)):
            tag = op[0]
            if tag == "coupling":
                x, ldj = _apply_coupling(op, prefs, x, th, ldj)
            elif tag == "affine":
                x = x * prefs[0] + prefs[1]
                if with_ldj:
                    ldj = ldj + prefs[2].reshape(())
            elif tag == "linear":
                x = x @ prefs[0]
                if with_ldj:
                    ldj = ldj + prefs[1].reshape(())
            elif tag == "logit":
                x, ldj = _apply_logit(op, prefs, x, ldj)
            else:
                raise ValueError(f"unknown chain op {tag!r}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return (x, ldj) if with_ldj else x


def chain_sample_plain(plan, params, rows, d, theta, *, noise=None,
                       generator=None):
    """Plain PyTorch version of ``chain_sample``: fold the given ``noise``
    (rows, d), or a ``torch.randn`` draw from ``generator``, forward through
    the plan. ``theta``: (rows, n), (1, n) or None."""
    if noise is None:
        device = params[0].device
        gen_device = generator.device if generator is not None else device
        noise = torch.randn(rows, d, generator=generator, device=gen_device,
                            dtype=torch.float32).to(device)
    if noise.shape != (rows, d):
        raise ValueError(f"noise must have shape {(rows, d)}")
    if theta is not None and theta.shape[-1] and theta.shape[0] == 1:
        theta = theta.expand(rows, theta.shape[-1])
    return chain_apply_plain(plan, params, noise, theta, with_ldj=False)


# -- lowering a plan to the kernels' program ----------------------------------

def _up4(v: int) -> int:
    return (v + 3) & ~3


def _float_bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


@dataclasses.dataclass
class PackedPlan:
    """A plan lowered for the kernels: ``prog`` (n_instr, 8) int32
    program words, ``flat``, one f32 buffer holding every parameter
    (matrices row-major with both extents zero-padded to a multiple of 4),
    and ``tiled``, the dense layers' weights as the kernels' products
    stream them (:func:`tile_weights`)."""

    plan: tuple
    d: int
    n: int
    hmax4: int          # widest padded hidden layer (0 without couplings)
    prog: torch.Tensor
    flat: torch.Tensor
    tiled: torch.Tensor

    @property
    def n_instr(self) -> int:
        return int(self.prog.shape[0])

    @property
    def ldh(self) -> int:
        # +4 floats so rows of the hidden buffers start on different banks
        return self.hmax4 + 4 if self.hmax4 else 0


class _Packer:
    def __init__(self, d, n, device):
        self.d, self.n = d, n
        self.n4, self.d4 = _up4(n), _up4(d)
        self.device = device
        self.chunks, self.offset = [], 0
        self.instrs = []
        self.hmax4 = 0

    def _add(self, t):
        off = self.offset
        self.chunks.append(t.reshape(-1))
        self.offset += t.numel()
        return off

    def matrix(self, w, rows4=None):
        k, m = w.shape
        out = torch.zeros(rows4 or _up4(k), _up4(m), dtype=torch.float32,
                          device=self.device)
        out[:k, :m] = w
        return self._add(out), out.shape[0], out.shape[1]

    def first_matrix(self, w_th, w_x):
        """θ block and x block merged into one (n4 + d4, H4) matrix that
        multiplies the kernel's [θ | x] input tile."""
        h = (w_th if w_th is not None else w_x).shape[1]
        out = torch.zeros(self.n4 + self.d4, _up4(h), dtype=torch.float32,
                          device=self.device)
        if w_th is not None:
            out[:self.n, :h] = w_th
        if w_x is not None:
            out[self.n4:self.n4 + self.d, :h] = w_x
        return self._add(out), out.shape[0], out.shape[1]

    def vector(self, b):
        b = b.reshape(-1)
        out = torch.zeros(_up4(b.numel()), dtype=torch.float32,
                          device=self.device)
        out[:b.numel()] = b
        return self._add(out)

    def emit(self, *words):
        words = list(words) + [0] * (_INSTR_WORDS - len(words))
        self.instrs.append([int(w) for w in words])

    def dense(self, src, dst, k4, n4, w_off, bias, act):
        b_off = self.vector(bias) if bias is not None else -1
        self.emit(_OP_DENSE, src, dst, k4, n4, w_off, b_off, ACT_CODES[act])

    def stack(self, ws, bs, act, n_stack, has_th, has_id):
        """The first ``n_stack`` dense layers of a net, each followed by the
        activation; returns (buffer holding the result, its K4, weights used)."""
        i = 0
        w_th = w_x = None
        if has_th:
            w_th = ws[i]
            i += 1
        if has_id:
            w_x = ws[i]
            i += 1
        src, k4 = _BUF_IN, self.n4 + self.d4
        for layer in range(n_stack):
            if layer == 0:
                w_off, _, n4 = self.first_matrix(w_th, w_x)
            else:
                w_off, _, n4 = self.matrix(ws[i], rows4=k4)
                i += 1
            dst = _BUF_HA if layer % 2 == 0 else _BUF_HB
            self.dense(src, dst, k4, n4, w_off, bs[layer], act)
            self.hmax4 = max(self.hmax4, n4)
            src, k4 = dst, n4
        return src, k4, i

    def net(self, ws, bs, act, n_layers, has_th, has_id, dst):
        """A whole conditioner: n_layers − 1 activated layers, then the
        linear folded final layer into the d-wide buffer ``dst``."""
        if n_layers < 2:
            raise ValueError("a folded conditioner needs at least 2 layers")
        src, k4, i = self.stack(ws, bs, act, n_layers - 1, has_th, has_id)
        w_off, _, n4 = self.matrix(ws[i], rows4=k4)
        self.dense(src, dst, k4, n4, w_off, bs[n_layers - 1], "identity")

    def coupling(self, op, prefs):
        (_, kind, dirn, n_s, n_t, act_s, act_t, bias_s, bias_t, has_th,
         has_id, clamp) = op
        if not (has_th or has_id):
            raise ValueError("coupling op without conditioner input")
        if kind == "joint":
            if n_s < 2:
                raise ValueError("a joint conditioner needs at least 2 layers")
            n_w = (1 if has_th else 0) + (1 if has_id else 0) + (n_s - 2) + 2
            ws = prefs[:n_w]
            bs = list(prefs[n_w:]) if bias_s else [None] * (n_s + 1)
            src, k4, i = self.stack(ws, bs, act_s, n_s - 1, has_th, has_id)
            for head, dst in ((0, _BUF_S), (1, _BUF_T)):
                w_off, _, n4 = self.matrix(ws[i + head], rows4=k4)
                self.dense(src, dst, k4, n4, w_off, bs[n_s - 1 + head],
                           "identity")
        else:
            k = 0
            if kind == "nvp":
                ws, bs, k = _net_slices(prefs, k, n_s, bias_s, has_th, has_id)
                self.net(ws, bs, act_s, n_s, has_th, has_id, _BUF_S)
            wt, bt, k = _net_slices(prefs, k, n_t, bias_t, has_th, has_id)
            self.net(wt, bt, act_t, n_t, has_th, has_id, _BUF_T)
        self.emit(_OP_COUPLE, _KIND_NICE if kind == "nice" else _KIND_NVP,
                  _DIRN[dirn], _float_bits(clamp))


def pack_plan(plan, params, d: int, n: int) -> PackedPlan:
    """Lower ``plan`` + ``params`` into the kernels' program and one flat
    parameter buffer, on the parameters' device."""
    device = params[0].device
    pk = _Packer(d, n, device)
    for op, prefs in zip(plan, _split_params(plan, params)):
        tag = op[0]
        if tag == "coupling":
            pk.coupling(op, prefs)
        elif tag == "affine":
            pk.emit(_OP_AFFINE, pk.vector(prefs[0]), pk.vector(prefs[1]),
                    pk.vector(prefs[2]))
        elif tag == "linear":
            w_off, k4, n4 = pk.matrix(prefs[0])
            pk.dense(_BUF_X, _BUF_S, k4, n4, w_off, None, "identity")
            pk.emit(_OP_COMMIT, pk.vector(prefs[1]))
        elif tag == "logit":
            _, dirn, eps = op
            pk.emit(_OP_LOGIT, _DIRN[dirn], _float_bits(eps),
                    pk.vector(prefs[0]), pk.vector(prefs[1]),
                    pk.vector(prefs[2]))
        else:
            raise ValueError(f"unknown chain op {tag!r}")
    prog = torch.tensor(pk.instrs, dtype=torch.int32, device=device)
    flat = torch.cat(pk.chunks).contiguous()
    return PackedPlan(tuple(plan), d, n, pk.hmax4, prog, flat,
                      tile_weights(flat, pk.instrs))


# the kernels' chunk of weights: _CHUNK_ROWS rows (K) by 32, 128 or 256
# columns (N), by the columns a pass of 256 has left (chunk_cols in
# csrc/chain_kernels.cu)
_CHUNK_ROWS = 16
_PASS_COLS = 256


def _chunk_cols(left: int) -> int:
    return 32 if left <= 32 else (128 if left <= 128 else _PASS_COLS)


def tile_weights(flat: torch.Tensor, instrs) -> torch.Tensor:
    """The weight matrices of the dense instructions, in the order and the
    layout in which the kernels' tensor-core products consume them: for each
    dense instruction, each pass of 256 columns, each chunk of 16 rows, one
    contiguous (cols x 16) tile in wgmma's K-major no-swizzle core-matrix
    layout — core matrix (n // 8, k // 4) of 8 x 4 floats at ((n // 8) * 4
    + k // 4) * 32 floats, element (n % 8, k % 4) at (n % 8) * 4 + k % 4 —
    zero past the matrix. A chunk is then one bulk copy."""
    tiles = []
    for ins in instrs:
        if ins[0] != _OP_DENSE:
            continue
        k4, n4, off = ins[3], ins[4], ins[5]
        w = flat[off:off + k4 * n4].view(k4, n4)
        k16 = -(-k4 // _CHUNK_ROWS) * _CHUNK_ROWS
        for c0 in range(0, n4, _PASS_COLS):
            cw = _chunk_cols(n4 - c0)
            part = flat.new_zeros(k16, cw)
            part[:k4, :min(cw, n4 - c0)] = w[:, c0:c0 + cw]
            # [chunk, k // 4, k % 4, n // 8, n % 8] -> [chunk, n // 8,
            # k // 4, n % 8, k % 4]
            tiles.append(part.view(k16 // _CHUNK_ROWS, 4, 4, cw // 8, 8)
                         .permute(0, 3, 1, 4, 2).reshape(-1))
    if not tiles:
        return flat.new_zeros(4)
    return torch.cat(tiles).contiguous()


def packed_apply_reference(packed: PackedPlan, x, theta, *, with_ldj,
                           matmul=None):
    """Execute a packed program instruction by instruction in PyTorch, on the
    padded buffers the kernel uses. It checks the lowering (offsets, padding,
    buffer routing) where no GPU is available; it is not a fast path.
    ``matmul(a, w)``: the product of a dense instruction (default ``a @
    w``), for a model of the kernel's arithmetic."""
    d, n = packed.d, packed.n
    n4, d4 = _up4(n), _up4(d)
    rows = x.shape[0]
    flat = packed.flat
    tile = x.new_zeros(rows, n4 + d4)
    if n:
        tile[:, :n] = theta
    tile[:, n4:n4 + d] = x
    bufs = {_BUF_IN: tile}
    ldj = x.new_zeros(rows)
    act_names = {v: k for k, v in ACT_CODES.items()}

    def unbits(i):
        return struct.unpack("<f", struct.pack("<i", int(i)))[0]

    for ins in packed.prog.tolist():
        op = ins[0]
        xs = tile[:, n4:n4 + d]
        if op == _OP_DENSE:
            _, src, dst, k4, m4, w_off, b_off, act = ins
            a = tile[:, n4:n4 + k4] if src == _BUF_X else bufs[src][:, :k4]
            w = flat[w_off:w_off + k4 * m4].reshape(k4, m4)
            u = a @ w if matmul is None else matmul(a, w)
            if b_off >= 0:
                u = u + flat[b_off:b_off + m4]
            bufs[dst] = _act(act_names[act], u)
        elif op == _OP_COUPLE:
            kind, dirn, clamp = ins[1], ins[2], unbits(ins[3])
            t = bufs[_BUF_T][:, :d]
            if kind == _KIND_NVP:
                s = bufs[_BUF_S][:, :d]
                if clamp > 0:
                    s = clamp * torch.tanh(s / clamp)
                if dirn == 0:
                    new, ldj = xs * torch.exp(s) + t, ldj + s.sum(-1)
                else:
                    new, ldj = (xs - t) * torch.exp(-s), ldj - s.sum(-1)
            else:
                new = xs + t if dirn == 0 else xs - t
            tile[:, n4:n4 + d] = new
        elif op == _OP_AFFINE:
            a = flat[ins[1]:ins[1] + d]
            b = flat[ins[2]:ins[2] + d]
            tile[:, n4:n4 + d] = xs * a + b
            ldj = ldj + flat[ins[3]]
        elif op == _OP_COMMIT:
            tile[:, n4:n4 + d] = bufs[_BUF_S][:, :d]
            ldj = ldj + flat[ins[1]]
        elif op == _OP_LOGIT:
            dirn, eps = ins[1], unbits(ins[2])
            lo, hi, wlog = (flat[o:o + d] for o in ins[3:6])
            if dirn == 0:
                z = xs
                new = lo + (hi - lo) * torch.sigmoid(z)
            else:
                u = ((xs - lo) / (hi - lo)).clamp(eps, 1.0 - eps)
                z = torch.log(u) - torch.log1p(-u)
                new = z
            row = (-F.softplus(-z) - F.softplus(z) + wlog).sum(-1)
            ldj = ldj + row if dirn == 0 else ldj - row
            tile[:, n4:n4 + d] = new
        else:
            raise ValueError(f"unknown opcode {op}")
    y = tile[:, n4:n4 + d].clone()
    return (y, ldj) if with_ldj else y


# -- launch configuration ------------------------------------------------------

def shared_memory_bytes(tile_rows: int, d: int, n: int, ldh: int) -> int:
    """Dynamic shared memory one block needs: the tile's buffers rounded up
    to 16 bytes, then the weight stream (mirrors ``block_floats`` in
    csrc/chain_kernels.cu). One hidden buffer, updated in place, where no
    hidden layer is wider than 256 columns; two else."""
    hidden = 1 if ldh - 4 <= _PASS_COLS else 2
    floats = (tile_rows * (_up4(n) + _up4(d) + 4) + hidden * tile_rows * ldh
              + 2 * tile_rows * (_up4(d) + 4) + tile_rows)
    return 4 * (_up4(floats) + _RING_FLOATS)


def pick_tile_rows(d: int, n: int, ldh: int) -> int:
    """The default row tile: the first of ``TILE_ROWS`` whose working set
    fits a block's shared memory (the larger tile measured faster at d 32,
    hidden 256 on an H100); raises when none does (the kernels' static
    limit)."""
    tb = next((t for t in TILE_ROWS
               if shared_memory_bytes(t, d, n, ldh) <= MAX_SHARED_BYTES),
              min(TILE_ROWS))
    if shared_memory_bytes(tb, d, n, ldh) > MAX_SHARED_BYTES:
        raise ValueError(
            f"chain too wide for the chain kernels: d={d}, n={n}, padded "
            f"hidden width {ldh} need {shared_memory_bytes(tb, d, n, ldh)} "
            f"bytes of shared memory at a {tb}-row tile "
            f"(limit {MAX_SHARED_BYTES})")
    return tb


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from .._build import load_library

        lib = load_library("chain_kernels")
        p, i = ctypes.c_void_p, ctypes.c_int
        ll = ctypes.c_longlong
        lib.df_chain_apply.argtypes = [
            p, p, p, p, p, i, p, p, ll, i, i, i, i, p]
        lib.df_chain_apply.restype = i
        lib.df_chain_sample.argtypes = [
            p, p, p, i, p, i, p, p, ll, i, i, i,
            ctypes.c_uint, ctypes.c_uint, ll, i, p]
        lib.df_chain_sample.restype = i
        _LIB = lib
    return _LIB


def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _resolve_packed(plan, params, packed, d, n, device):
    if packed is None:
        packed = pack_plan(plan, params, d, n)
    if packed.plan != tuple(plan):
        raise ValueError("packed plan was lowered from another plan")
    if packed.d != d or packed.n != n:
        raise ValueError(
            f"packed plan is for (d, n) = ({packed.d}, {packed.n}), "
            f"got ({d}, {n})")
    if packed.flat.device != device:
        raise ValueError(
            f"plan parameters are on {packed.flat.device}, data on {device}")
    return packed


def _tile_rows(tile_rows, d, n, ldh):
    if tile_rows is None:
        return pick_tile_rows(d, n, ldh)
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {TILE_ROWS}")
    if shared_memory_bytes(tile_rows, d, n, ldh) > MAX_SHARED_BYTES:
        raise ValueError(f"tile_rows={tile_rows} exceeds shared memory")
    return tile_rows


def run_chain(plan, params, x, theta, *, with_ldj, packed=None,
              tile_rows=None):
    """Fold ``x`` (B, d) through a chain plan.

    ``theta``: (B, n) or None / zero-width. Returns ``(y, ldj)`` with ldj
    (B,) f32, or ``y`` alone when ``with_ldj`` is False. On a CUDA tensor
    this launches the ``chain_apply`` kernel on the current stream (the
    ragged last tile is masked inside the kernel); on a CPU tensor it runs
    ``chain_apply_plain``. Not differentiable: see
    ``models/fused_chain.py`` for the autograd wrapper. ``packed``: a
    ``pack_plan`` result to reuse, else the plan is packed here.
    """
    if x.dim() != 2:
        raise ValueError("x must have shape (B, d)")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    rows, d = x.shape
    n = theta.shape[-1] if theta is not None else 0
    if n == 0:
        theta = None
    if x.device.type == "cpu":
        return chain_apply_plain(plan, params, x, theta, with_ldj=with_ldj)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, "x", (rows, d), x.device)
    if theta is not None:
        _check(theta, "theta", (rows, n), x.device)
    packed = _resolve_packed(plan, params, packed, d, n, x.device)
    tb = _tile_rows(tile_rows, d, n, packed.ldh)
    y = torch.empty_like(x)
    ldj = torch.empty(rows, dtype=torch.float32, device=x.device) \
        if with_ldj else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().df_chain_apply(
            x.data_ptr(), theta.data_ptr() if theta is not None else None,
            y.data_ptr(), ldj.data_ptr() if with_ldj else None,
            packed.prog.data_ptr(), packed.n_instr, packed.flat.data_ptr(),
            packed.tiled.data_ptr(), rows, d, n, packed.ldh, tb, stream)
    if err != 0:
        raise RuntimeError(f"chain_apply launch failed (CUDA error {err})")
    run_chain.launches += 1
    return (y, ldj) if with_ldj else y


run_chain.launches = 0


def _seed_from(generator) -> int:
    """A 64-bit key for the in-kernel generator, drawn from ``generator``
    (so successive calls with one generator give different streams)."""
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    words = torch.randint(0, 2**32, (2,), generator=generator,
                          device=generator.device, dtype=torch.int64)
    lo, hi = (int(w) for w in words.tolist())
    return (hi << 32) | lo


def run_chain_sample(plan, params, rows, d, theta, *, generator=None,
                     seed=None, packed=None, tile_rows=None,
                     return_noise=False, row_offset=0, total_rows=None):
    """Draw ``rows`` base samples N(0, I_d) and fold them forward through the
    plan. ``theta``: (rows, n), (1, n) (broadcast without being
    materialised) or None. Returns (rows, d), or ``(samples, noise)`` with
    ``return_noise=True``.

    The device is the parameters'. On CUDA the
    ``chain_sample`` kernel draws inside the kernel with Philox4x32-10 keyed
    by ``seed`` (64-bit; taken from ``generator`` when not given), its
    counter the GLOBAL row ``row_offset + r``: a launch of rows ``[lo, hi)``
    of a larger draw with ``row_offset=lo`` gives exactly those rows of the
    one-launch draw. On the CPU ``chain_sample_plain`` draws with
    ``torch.randn(generator=...)``; with a ``row_offset`` (or
    ``total_rows``) it draws the whole ``(total_rows, d)`` (default
    ``row_offset + rows``) and folds rows ``[row_offset, row_offset +
    rows)`` of it, which are the rows of the one-call draw of
    ``total_rows``.
    """
    device = params[0].device
    n = theta.shape[-1] if theta is not None else 0
    if n == 0:
        theta = None
    if theta is not None and theta.shape[0] not in (1, rows):
        raise ValueError("theta rows must be 1 or match the draw count")
    row_offset = int(row_offset)
    if row_offset < 0:
        raise ValueError("row_offset must be >= 0")
    if device.type == "cpu":
        if seed is not None:
            generator = torch.Generator().manual_seed(seed % (2**63))
        total = row_offset + rows if total_rows is None else int(total_rows)
        if total < row_offset + rows:
            raise ValueError("total_rows must cover row_offset + rows")
        noise = torch.randn(total, d, generator=generator,
                            dtype=torch.float32)
        if total != rows:
            noise = noise[row_offset:row_offset + rows].contiguous()
        out = chain_sample_plain(plan, params, rows, d, theta, noise=noise)
        return (out, noise) if return_noise else out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if theta is not None:
        _check(theta, "theta", (theta.shape[0], n), device)
    packed = _resolve_packed(plan, params, packed, d, n, device)
    tb = _tile_rows(tile_rows, d, n, packed.ldh)
    if seed is None:
        seed = _seed_from(generator)
    seed &= (1 << 64) - 1
    y = torch.empty(rows, d, dtype=torch.float32, device=device)
    noise = torch.empty_like(y) if return_noise else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().df_chain_sample(
            y.data_ptr(), noise.data_ptr() if return_noise else None,
            theta.data_ptr() if theta is not None else None,
            1 if theta is not None and theta.shape[0] == 1 else 0,
            packed.prog.data_ptr(), packed.n_instr, packed.flat.data_ptr(),
            packed.tiled.data_ptr(), rows, d, n, packed.ldh,
            seed & 0xFFFFFFFF, seed >> 32, row_offset, tb, stream)
    if err != 0:
        raise RuntimeError(f"chain_sample launch failed (CUDA error {err})")
    run_chain_sample.launches += 1
    return (y, noise) if return_noise else y


run_chain_sample.launches = 0


def reset_launch_counts() -> None:
    run_chain.launches = 0
    run_chain_sample.launches = 0


def launch_counts() -> dict:
    return {"chain_apply": run_chain.launches,
            "chain_sample": run_chain_sample.launches}


# -- the in-kernel generator, in numpy ------------------------------------------

def _philox4x32_10(c, k):
    """Philox4x32-10 on uint32 arrays: ``c`` (4, ...) counters, ``k`` (2, ...)
    keys. Same rounds as the kernel's ``philox4x32_10``."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)
    c0, c1, c2, c3 = (np.asarray(v, np.uint32) for v in c)
    k0, k1 = (np.asarray(v, np.uint32) for v in k)
    mask = np.uint64(0xFFFFFFFF)
    shift = np.uint64(32)
    with np.errstate(over="ignore"):
        for _ in range(10):
            p0 = m0 * c0.astype(np.uint64)
            p1 = m1 * c2.astype(np.uint64)
            hi0, lo0 = (p0 >> shift).astype(np.uint32), (p0 & mask).astype(np.uint32)
            hi1, lo1 = (p1 >> shift).astype(np.uint32), (p1 & mask).astype(np.uint32)
            c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
            k0 = (k0 + w0).astype(np.uint32)
            k1 = (k1 + w1).astype(np.uint32)
    return c0, c1, c2, c3


def philox_normal_reference(seed: int, rows: int, d: int,
                            row_offset: int = 0) -> np.ndarray:
    """The ``chain_sample`` kernel's base draw in numpy: counter = (row,
    column pair), key = the 64-bit seed, Box–Muller (cosine branch) on
    24-bit-mantissa uniforms. Agrees with the kernel up to the rounding of
    ``log1p`` / ``cos`` / ``sqrt`` on the two machines."""
    seed &= (1 << 64) - 1
    pairs = (d + 1) // 2
    g = np.arange(row_offset, row_offset + rows, dtype=np.uint64)[:, None]
    g = np.broadcast_to(g, (rows, pairs))
    p = np.broadcast_to(np.arange(pairs, dtype=np.uint32)[None, :],
                        (rows, pairs))
    bits = _philox4x32_10(
        ((g & np.uint64(0xFFFFFFFF)).astype(np.uint32),
         (g >> np.uint64(32)).astype(np.uint32), p, np.zeros_like(p)),
        (np.full(p.shape, seed & 0xFFFFFFFF, np.uint32),
         np.full(p.shape, seed >> 32, np.uint32)))
    scale = np.float32(1.0 / 16777216.0)

    def box_muller(b1, b2):
        u1 = (b1 >> np.uint32(8)).astype(np.float32) * scale
        u2 = (b2 >> np.uint32(8)).astype(np.float32) * scale
        return (np.sqrt(np.float32(-2.0) * np.log1p(-u1))
                * np.cos(np.float32(2.0 * math.pi) * u2)).astype(np.float32)

    out = np.empty((rows, 2 * pairs), np.float32)
    out[:, 0::2] = box_muller(bits[0], bits[1])
    out[:, 1::2] = box_muller(bits[2], bits[3])
    return out[:, :d]
