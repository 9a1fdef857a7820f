#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``densityflows_tpu_torch`` from the sources in
this checkout (into ``build/``, one ``nvcc`` per source, started together),
holds each kernel against its plain PyTorch version on the card, then drives
the port's main paths through the entry points a user calls:

- serving, at the full width of the flagship emulator config — d 32, n 8
  conditions, 4 coupling blocks (8 RealNVP couplings) with hidden 256, a
  trailing normalization layer, 2^18 rows: ``save_flow`` → ``load_flow`` →
  ``log_prob`` / ``sample`` / ``sample_sweep`` / ``forward`` / ``inverse``,
  for the split (s-net + t-net) and the joint-conditioner parameterization.
  Weights and data are random, from ``numpy.random.default_rng(seed)``;
- training, at the README / BASELINE config — the 5-D conditional
  ``tests/fixtures/datatest.npz`` data, three RealNVP couplings of hidden 16
  and a normalization layer, Adam 1e-3, batch 64, 50 epochs:
  ``train(flow, data, epochs=50, generator=...)`` with default routing (the
  whole-run ``train_run`` kernel), held against the plain program on the
  same batch order, then ``evaluate``, ``save_flow`` with the optimizer
  state → ``load_flow`` → 5 more epochs, and ``sample``. ``train()`` on the
  wide serving chain takes the stream mode (``train_stream``), beside the
  plain program on the same batches; a chain with an "elu" conditioner shows
  the visible decline to the plain program;
- streaming training, at the widest recorded step-kernel config — d 16, n 4,
  three RealNVP couplings of hidden 64 and a normalization layer, Adam 1e-3,
  batch 1024, streamed from 2^20 host rows for 3 epochs (3,072 steps) with
  2^14 validation rows: ``train_streaming(flow, x, theta, ...)`` through the
  native loader and the grads-only ``step_grads`` kernel, held against the
  plain step on the same batches; then the README / BASELINE config from
  50,000 host rows for 2 epochs;
- data-parallel training on a one-rank NCCL process group:
  ``train(flow, data, mesh=make_mesh())`` at the README / BASELINE config on
  the step-kernel program, held against the single-device plain program;
- the streaming whole-run trainer, at the same d 16 / n 4 / hidden 64 /
  batch 1024 config: ``train(flow, data, epochs=3, batchsize=1024,
  generator=...)`` on a DataArrays of the same 2^20 rows held on the card,
  which takes ``train_fused``'s stream mode (one ``train_stream`` launch),
  held against the plain version over its first 32 steps;
- the opt-in per-layer coupling kernels, at the wide config of
  ``benchmarks/wide_config.py`` ("fused_f32"): 32 steps of
  ``make_train_step(adam(1e-3))`` under ``set_fused_kernels(True)`` on the
  wide split chain at batch 8192 from 2^16 rows (each coupling of the loss
  launches ``coupling_fwd``, its gradient ``coupling_bwd``), held against the
  plain autograd step; then ``train(..., fused_kernel=False)`` under ``True``
  and a chain the chain kernel declines (``log_prob`` / ``sample``).

Every phase fails the run (non-zero exit) on its own failure; there is no
CPU fallback. Without a CUDA device the script exits non-zero and prints no
result. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists, per kernel, its error against the plain version,
its launches on the main path, its time, the plain version's time and the
roofline bound for the same work.
"""

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch import _build, native
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.models import fused_train as ft
from densityflows_tpu_torch.ops import chain_kernels as ck
from densityflows_tpu_torch.ops import coupling as cpl
from densityflows_tpu_torch.ops import coupling_kernels as cpk
from densityflows_tpu_torch.ops import step_kernels as sk
from densityflows_tpu_torch.ops import stream_kernels as stk
from densityflows_tpu_torch.ops import train_kernels as tk
from densityflows_tpu_torch.train import (
    _fold_adam_state,
    _folded_adam_,
    _loss_and_grads,
)

SEED = 0
D, N_COND, HIDDEN, N_BLOCKS, ROWS = 32, 8, 256, 4, 1 << 18

# Published peaks of one H100 SXM at its full 700 W limit: device memory
# 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s, TF32 on the tensor
# cores 495 TFLOP/s (dense). The training and coupling kernels do their
# products as f32 FMA, so their bounds use the f32 rate; the chain kernels
# do every product as three TF32 products (3xTF32), so theirs is three times
# the products over the TF32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# kernel vs plain version: the kernel's products (3xTF32 in the chain
# kernels, f32 FMA elsewhere) summed over K in its own order against the
# library's f32 products (TF32 off), through up to 24 dense layers and 8
# exp() couplings
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)

# train_run vs its plain version after 4 epochs of Adam on 137 rows: the same
# f32 arithmetic, summed in another order (the kernel loops over rows and
# columns with fmaf, the plain version calls the library's products)
TRAIN_TOL = dict(rtol=0.0, atol=1e-4)
TRAIN_EPOCHS, TRAIN_BATCH = 50, 64

# step_grads vs its plain version on one batch: the same f32 arithmetic,
# summed over rows and tiles in another order
STEP_TOL = dict(rtol=0.0, atol=1e-4)
# the streaming main path: the widest config the repo records for the step
# kernel (benchmarks/step_kernel_probe.py "med"), not cut
MED = dict(d=16, n=4, hidden=64, batch=1024, rows=1 << 20, valid=1 << 14,
           epochs=3)
# the README / BASELINE model streamed from 50,000 rows
# (benchmarks/stream_crossover.py)
STREAM50K = dict(rows=50_000, batch=TRAIN_BATCH, epochs=2, valid=5_000)
MESH_EPOCHS = 4


def say(**fields):
    print(json.dumps(fields), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require_close(got, want, what, rtol, atol):
    got, want = got.detach(), want.detach()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if bool((err > bound).any()):
        fail(f"{what}: max abs err {float(err.max()):.3e} exceeds "
             f"atol {atol} + rtol {rtol}")
    return float(err.max())


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, warmup=2, runs=7):
    """Median over ``runs`` of one call's time on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms_by_kernel(fn, calls=20):
    """Device time per call of each kernel that ``fn`` launches, summed over
    its launches, from torch.profiler (CUPTI); ``None`` where the profiler
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    return out or None


def launch_ms(fn, per_call, calls=5):
    """Device time of each of the ``per_call`` kernel launches of one call
    of ``fn``, in launch order: ``[name, ms]``, the median over ``calls``
    profiles (torch.profiler), each of a call of ``fn`` after one that is
    not counted (the profiler can miss a session's first launches)."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted(
            (ev.time_range.start,
             ev.name.replace("(anonymous namespace)::", "").split("(")[0],
             ev.time_range.elapsed_us() / 1e3)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
        runs.append(events[-per_call:])
    return [[runs[0][i][1], statistics.median(r[i][2] for r in runs)]
            for i in range(per_call)]


def host_split_ms(fn, reps=200):
    """``(host_ms, back_to_back_ms)`` per call over ``reps`` calls issued
    back to back: the host clock until the last call returns (the enqueue
    cost), and CUDA events around them all (the device's pace when the host
    keeps ahead, else the host's)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    e1.record()
    torch.cuda.synchronize()
    return host, e0.elapsed_time(e1) / reps


# -- chains ----------------------------------------------------------------

def numpy_weights_(chain, rng, final_scale):
    """Overwrite every conditioner weight with a glorot-uniform numpy draw;
    final layers are scaled down so exp(s) stays finite through the chain."""
    with torch.no_grad():
        for layer in fc._iter_layers(chain, "fwd"):
            for net in fc._conditioner_nets(layer):
                last = len(net.weights) - 1
                for i, w in enumerate(net.weights):
                    limit = np.sqrt(6.0 / sum(w.shape))
                    a = rng.uniform(-limit, limit, size=tuple(w.shape))
                    if i == last:
                        a = a * final_scale
                    w.copy_(torch.as_tensor(a.astype(np.float32)))
                for b in net.biases:
                    b.copy_(torch.as_tensor(rng.normal(
                        size=tuple(b.shape)).astype(np.float32) * 0.05))
    return chain


def wide_chain(joint, rng, device):
    x_ref = rng.normal(size=(512, D)).astype(np.float32)
    chain = dt.flow_chain(
        *[dt.coupling_block(D, None, n=N_COND, hidden_dim_s=HIDDEN,
                            hidden_dim_t=HIDDEN, joint_conditioner=joint,
                            device=device) for _ in range(N_BLOCKS)],
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))
    return numpy_weights_(chain, rng, 0.1)


ACTIVATIONS = ["relu", "tanh", "sigmoid", "silu", "gelu", "softplus", "elu",
               "leaky_relu", "identity"]


def mixed_chain(d, n, h, rng, device, logit):
    """Every op tag, the three coupling kinds, a tanh clamp, no-bias nets,
    nets of 2 to 4 layers, each of the nine activations, widths that are no
    multiple of 4."""
    g = torch.Generator().manual_seed(SEED)
    x_ref = rng.normal(size=(64, d)).astype(np.float32) * 2.0 + 0.5
    kw = dict(n=n, device=device, hidden_dim_s=h, hidden_dim_t=h)
    lo_half, hi_half = list(range(d // 2)), list(range(d // 2, d))
    layers = []
    for i, act in enumerate(ACTIVATIONS):
        layers.append(dt.coupling_layer(
            d, lo_half if i % 2 else hi_half, activation_s=act,
            activation_t=act, bias=bool(i % 3), n_sublayers_s=1 + i % 3,
            n_sublayers_t=1 + (i + 1) % 3, **kw))
    layers += [
        dt.actnorm_layer(x_ref, device=device),
        dt.coupling_block(d, None, **kw),
        dt.permutation_layer(d, generator=g),
        dt.coupling_layer(d, lo_half, kind=dt.NICECouplingLayer, **kw),
        dt.coupling_layer(d, hi_half, joint_conditioner=True,
                          max_log_scale=2.0, activation_s="tanh",
                          activation_t="tanh", **kw),
        dt.coupling_layer(d, lo_half, max_log_scale=1.0, bias=False, **kw),
        dt.invertible_linear_layer(d, generator=g, device=device),
    ]
    if logit:
        layers.append(dt.logit_layer((np.full(d, -60.0, np.float32),
                                      np.full(d, 60.0, np.float32)),
                                     device=device))
    else:
        layers.append(dt.normalization_layer(x_ref, -1.0, 1.0, device=device))
    return numpy_weights_(dt.flow_chain(*layers), rng, 0.3)


def data(rng, rows, d, n, device):
    x = torch.as_tensor((rng.normal(size=(rows, d)) * 0.5).astype(np.float32))
    th = torch.as_tensor(rng.uniform(size=(rows, n)).astype(np.float32))
    return x.to(device), th.to(device)


# -- phase 3: kernels against their plain versions ------------------------------

def check_apply(chain, x, th, what, tiles=ck.TILE_ROWS):
    """chain_apply, fwd and inv, with and without ldj, at every row tile."""
    worst = 0.0
    for dirn in ("fwd", "inv"):
        plan, params = fc._plan_params(chain, dirn)
        want_y, want_l = ck.chain_apply_plain(plan, params, x, th,
                                              with_ldj=True)
        for tb in tiles:
            y, ldj = ck.run_chain(plan, params, x, th, with_ldj=True,
                                  tile_rows=tb)
            torch.cuda.synchronize()
            y2 = ck.run_chain(plan, params, x, th, with_ldj=False,
                              tile_rows=tb)
            torch.cuda.synchronize()
            tag = f"{what} {dirn} tile {tb}"
            worst = max(worst,
                        require_close(y, want_y, tag + " y", **KERNEL_TOL),
                        require_close(ldj, want_l, tag + " ldj", **KERNEL_TOL),
                        require_close(y2, want_y, tag + " y (no ldj)",
                                      **KERNEL_TOL))
    return worst


def fitting_tiles(chain, d, n):
    """The row tiles whose working set fits one block for this chain."""
    plan, params = fc._plan_params(chain, "fwd")
    ldh = ck.pack_plan(plan, params, d, n).ldh
    return tuple(tb for tb in ck.TILE_ROWS
                 if ck.shared_memory_bytes(tb, d, n, ldh)
                 <= ck.MAX_SHARED_BYTES)


def check_wide_hidden(rng, device):
    """Hidden layers wider than one pass of 256 columns (300 and 520): two
    hidden buffers, ping-pong, and every dense layer of that width in two
    passes, the second narrower; chain_apply at every row tile that fits,
    chain_sample at the default one against the plain fold of its draws."""
    worst = 0.0
    for h in (300, 520):
        chain = mixed_chain(7, 3, h, rng, device, logit=True)
        x, th = data(rng, 257, 7, 3, device)
        worst = max(worst, check_apply(chain, x, th, f"mixed d7 n3 h{h}",
                                       tiles=fitting_tiles(chain, 7, 3)))
        plan, params = fc._plan_params(chain, "fwd")
        y, r = ck.run_chain_sample(plan, params, 257, 7, th, seed=3,
                                   return_noise=True)
        torch.cuda.synchronize()
        want = ck.chain_sample_plain(plan, params, 257, 7, th, noise=r)
        worst = max(worst, require_close(y, want, f"mixed sample h{h}",
                                         **KERNEL_TOL))
    return worst


def check_sample(chain, rows, d, th, what):
    """chain_sample with the base draws written out: the plain fold of the
    draws equals the kernel's samples; the draws are N(0, 1); two seeds
    differ; one seed gives the same draws at every row tile."""
    plan, params = fc._plan_params(chain, "fwd")
    outs = {}
    for tb in ck.TILE_ROWS:
        outs[tb] = ck.run_chain_sample(plan, params, rows, d, th, seed=1234,
                                       tile_rows=tb, return_noise=True)
        torch.cuda.synchronize()
    (y, r), *others = (outs[tb] for tb in ck.TILE_ROWS)
    for y_b, r_b in others:
        if not torch.equal(r, r_b):
            fail(f"{what}: base draws depend on the row tile")
        require_close(y_b, y, f"{what}: samples at two row tiles", 1e-6,
                      1e-6)
    want = ck.chain_sample_plain(plan, params, rows, d, th, noise=r)
    err = require_close(y, want, f"{what}: samples vs plain fold of r_out",
                        **KERNEL_TOL)
    # the kernel's generator is the documented Philox4x32-10 + Box-Muller
    # (tolerance: log1p / cos / sqrt round differently on the host)
    head = min(rows, 4096)
    ref = torch.as_tensor(ck.philox_normal_reference(1234, head, d)).to(r.device)
    require_close(r[:head], ref, f"{what}: r_out vs numpy Philox", 0.0, 1e-5)
    # moments of N(0, 1), each within 5 standard errors
    m = r.numel()
    r64 = r.double()
    z = {"mean": float(r64.mean()) * np.sqrt(m),
         "var": (float(r64.var()) - 1.0) / np.sqrt(2.0 / m),
         "m4": (float((r64 ** 4).mean()) - 3.0) / np.sqrt(96.0 / m)}
    if not bool(torch.isfinite(r).all()) or max(abs(v) for v in z.values()) > 5:
        fail(f"{what}: base draws are not N(0,1): z = {z}")
    y_other = ck.run_chain_sample(plan, params, rows, d, th, seed=1235)
    torch.cuda.synchronize()
    if torch.equal(y_other, y):
        fail(f"{what}: two seeds gave the same draws")
    return err, z


def check_gradient(chain, x, th):
    """The autograd.Function around chain_apply against the plain
    per-layer path."""
    def grads(fused):
        xx = x.clone().requires_grad_(True)
        tt = th.clone().requires_grad_(True)
        chain.zero_grad()
        if fused:
            z, ldj = fc.maybe_apply_fused(chain, xx, tt, "inv", True)
        else:
            z, ldj = fc.fold_layers(chain, xx, tt, "inv", True)
        ((z ** 2).sum() - ldj.sum()).backward()
        return [xx.grad, tt.grad] + [p.grad for p in chain.parameters()]

    worst = 0.0
    for i, (a, b) in enumerate(zip(grads(True), grads(False))):
        if (a is None) != (b is None):
            fail(f"gradient {i}: present on one path only")
        if a is not None:
            scale = float(b.abs().max()) + 1.0
            worst = max(worst, require_close(a, b, f"gradient {i}", 1e-3,
                                             1e-4 * scale))
    return worst


def nan_relu_logit_chain(d, n, h, rng, device):
    """Relu couplings (two and three dense layers, one without bias) and a
    trailing LogitLayer over (-60, 60): the places where a hand-written
    chain kernel could swallow a NaN (relu, the logit's clamp)."""
    lo, hi = list(range(d // 2)), list(range(d // 2, d))
    kw = dict(n=n, device=device, hidden_dim_s=h, hidden_dim_t=h,
              activation_s="relu", activation_t="relu")
    chain = dt.flow_chain(
        dt.coupling_layer(d, lo, n_sublayers_s=2, n_sublayers_t=2, **kw),
        dt.coupling_layer(d, hi, bias=False, **kw),
        dt.coupling_layer(d, lo, **kw),
        dt.logit_layer((np.full(d, -60.0, np.float32),
                        np.full(d, 60.0, np.float32)), device=device))
    return numpy_weights_(chain, rng, 0.3)


def check_chain_nan(rng, device):
    """Rows holding a NaN (an identity dim, a transformed dim, a condition)
    or a +-inf (x and conditions) through a relu chain with a LogitLayer:
    chain_apply forward and inverse with ldj and chain_sample (NaN and
    +-inf condition rows), each at every row tile, and ``Flow.log_prob`` on
    the chain route, each with the plain version's pattern of NaN and of
    +-inf entries."""
    d, n, rows = 7, 3, 1001
    chain = nan_relu_logit_chain(d, n, 18, rng, device)
    x = put(rng.uniform(-5, 5, size=(rows, d)), device)
    th = put(rng.uniform(size=(rows, n)), device)
    x[3, 1] = float("nan")
    x[500, 5] = float("nan")
    th[11, 0] = float("nan")
    # log_prob's per-layer route reads no folded zero rows, so inf * 0 = NaN
    # is the folded route's own: the two routes are compared on NaN rows
    x_nan, th_nan = x.clone(), th.clone()
    inf_rows = (7, 640, 30, 901)
    x[7, 2] = float("inf")
    x[640, 6] = -float("inf")
    th[30, 2] = -float("inf")
    th[901, 1] = float("inf")
    worst, nan_rows = 0.0, {}
    for dirn in ("fwd", "inv"):
        plan, params = fc._plan_params(chain, dirn)
        want_y, want_l = ck.chain_apply_plain(plan, params, x, th,
                                              with_ldj=True)
        nan_rows[dirn] = int(torch.isnan(want_l).sum())
        nan_rows[dirn + "_inf_entries"] = int(torch.isinf(want_y).sum())
        # the NaN rows are NaN, and no row but those and the inf rows is
        got_rows = set(torch.nonzero(torch.isnan(want_l)).flatten().tolist())
        if not {3, 500, 11} <= got_rows <= {3, 500, 11, *inf_rows}:
            fail(f"chain NaN rows {dirn}: the plain version's NaN rows are "
                 f"{sorted(got_rows)}")
        for tb in ck.TILE_ROWS:
            y, ldj = ck.run_chain(plan, params, x, th, with_ldj=True,
                                  tile_rows=tb)
            torch.cuda.synchronize()
            tag = f"chain_apply NaN / inf rows {dirn} tile {tb}"
            worst = max(worst, require_close_nan(y, want_y, tag + " y"),
                        require_close_nan(ldj, want_l, tag + " ldj"))
    plan, params = fc._plan_params(chain, "fwd")
    th_s = th.clone()
    th_s[[7, 640]] = torch.tensor([[float("inf"), 0.5, 0.5],
                                   [0.5, -float("inf"), 0.5]],
                                  device=device)
    for tb in ck.TILE_ROWS:
        y, r = ck.run_chain_sample(plan, params, rows, d, th_s, seed=5,
                                   return_noise=True, tile_rows=tb)
        torch.cuda.synchronize()
        want = ck.chain_sample_plain(plan, params, rows, d, th_s, noise=r)
        if not bool(torch.isnan(want[11]).all()):
            fail("chain_sample NaN condition row: the plain version is "
                 "finite")
        worst = max(worst, require_close_nan(
            y, want, f"chain_sample NaN / inf rows tile {tb}"))
    nan_rows["sample_nonfinite_rows"] = int(
        (~torch.isfinite(want)).any(1).sum())
    nan_rows["inf_rows"] = list(inf_rows)
    flow = dt.Flow(chain, dt.MetaData("", d, n, np.zeros(n), np.ones(n)),
                   device=device)
    lp = {}
    for mode in ("auto", False):
        dt.set_fused_kernels(mode)
        try:
            with torch.no_grad():
                lp[mode] = flow.log_prob(x_nan, th_nan)
            torch.cuda.synchronize()
        finally:
            dt.set_fused_kernels("auto")
    worst = max(worst, require_close_nan(lp["auto"], lp[False],
                                        "log_prob NaN rows, chain route"))
    return worst, nan_rows


# -- phase 4: the main path ---------------------------------------------------

def moment_gate(flow, theta_tuple, rows):
    """Per-dimension moments of the in-kernel sampler against the plain
    sampler's (torch.randn + per-layer fold), over three seeds. Statistic
    per seed: z = max over dims of |Δmean| / (√2·se). Gates: every seed
    z ≤ 5, median z ≤ 4, every per-dim std ratio within 5 %."""
    zs = []
    for seed in (11, 21, 31):
        s_k = flow.sample((rows,), theta_tuple,
                          generator=torch.Generator().manual_seed(seed))
        dt.set_fused_kernels(False)
        try:
            s_p = flow.sample((rows,), theta_tuple,
                              generator=torch.Generator().manual_seed(seed + 1))
        finally:
            dt.set_fused_kernels("auto")
        s_k, s_p = s_k.detach().double(), s_p.detach().double()
        if not bool(torch.isfinite(s_k).all()):
            fail("in-kernel sampler produced non-finite draws")
        se = s_p.std(0) / np.sqrt(rows)
        z = float(((s_k.mean(0) - s_p.mean(0)).abs() / (np.sqrt(2) * se)).max())
        ratio = s_k.std(0) / s_p.std(0)
        if z > 5.0 or float((ratio - 1).abs().max()) > 0.05:
            fail(f"sampler moments diverged (seed {seed}): z={z}, "
                 f"std ratios {ratio.tolist()}")
        zs.append(z)
    if statistics.median(zs) > 4.0:
        fail(f"sampler shows a persistent moment bias: z by seed {zs}")
    return zs


def drive_main_path(joint, rng, device, tmp):
    """save_flow → load_flow → log_prob / sample / sample_sweep / forward /
    inverse at full width. Returns the loaded flow and its inputs."""
    name = "joint" if joint else "split"
    theta_min = np.linspace(-1.0, 0.0, N_COND).astype(np.float32)
    theta_max = np.linspace(1.0, 3.0, N_COND).astype(np.float32)
    meta = dt.MetaData(name, D, N_COND, theta_min, theta_max)
    built = dt.Flow(wide_chain(joint, rng, device), meta, device=device)
    path = f"{tmp}/{name}"
    dt.save_flow(path, built)
    flow = dt.load_flow(path, device=device)
    for a, b in zip(flow.model.state_dict().values(),
                    built.model.state_dict().values()):
        if not torch.equal(a, b):
            fail(f"{name}: load_flow did not restore the weights")

    x, th01 = data(rng, ROWS, D, N_COND, device)
    theta = (torch.as_tensor(theta_min) + torch.as_tensor(theta_max - theta_min)
             * th01.cpu()).to(device)
    theta_tuple = tuple(float(v) for v in (theta_min + theta_max) / 2)

    with torch.no_grad():
        lp = flow.log_prob(x, theta)
        s = flow.sample((ROWS,), theta_tuple,
                        generator=torch.Generator().manual_seed(SEED))
        sweep = flow.sample_sweep(theta[:64], 4096,
                                  generator=torch.Generator().manual_seed(SEED))
        z = torch.as_tensor(rng.normal(size=(ROWS, D)).astype(np.float32)
                            ).to(device)
        xf, ldj_f = flow.forward(z, theta)
        zb, ldj_b = flow.inverse(xf, theta)
    torch.cuda.synchronize()

    if lp.shape != (ROWS,) or s.shape != (ROWS, D) or \
            sweep.shape != (64, 4096, D):
        fail(f"{name}: wrong output shapes")
    for what, v in (("log_prob", lp), ("sample", s), ("sample_sweep", sweep)):
        if not bool(torch.isfinite(v).all()):
            fail(f"{name}: {what} has non-finite values")
    require_close(zb, z, f"{name}: inverse(forward(z))", 1e-3, 1e-3)
    require_close(ldj_f + ldj_b, torch.zeros_like(ldj_f),
                  f"{name}: ldj_fwd + ldj_inv", 0.0, 1e-3)
    return flow, x, theta, theta_tuple, lp


def check_main_path(flow, x, theta, theta_tuple, lp, name):
    """log_prob against the per-layer plain path; the sampler's moments."""
    dt.set_fused_kernels(False)
    try:
        with torch.no_grad():
            lp_plain = flow.log_prob(x, theta)
    finally:
        dt.set_fused_kernels("auto")
    # |log p| is O(50) here; same tolerance reasoning as KERNEL_TOL
    err = require_close(lp, lp_plain, f"{name}: log_prob vs per-layer path",
                        1e-4, 1e-3)
    with torch.no_grad():
        zs = moment_gate(flow, theta_tuple, ROWS)
    return err, zs


def grid_log_prob(rng, device):
    """Grid form of log_prob on a small-d flow, in chunks through the same
    kernel, against the per-layer path."""
    d = 3
    chain = numpy_weights_(dt.flow_chain(
        dt.coupling_block(d, [0], n=1, hidden_dim_s=32, hidden_dim_t=32,
                          device=device),
        dt.coupling_block(d, [1, 2], n=1, hidden_dim_s=32, hidden_dim_t=32,
                          device=device)), rng, 0.3)
    flow = dt.Flow(chain, dt.MetaData("", d, 1, np.zeros(1), np.ones(1) * 2),
                   device=device)
    vecs = (np.linspace(-2, 2, 64).astype(np.float32),
            np.linspace(-2, 2, 64).astype(np.float32),
            np.linspace(-1, 1, 40).astype(np.float32))
    with torch.no_grad():
        lp = flow.log_prob(vecs, (1.0,), grid_chunk=65536)
    torch.cuda.synchronize()
    dt.set_fused_kernels(False)
    try:
        with torch.no_grad():
            want = flow.log_prob(vecs, (1.0,), grid_chunk=65536)
    finally:
        dt.set_fused_kernels("auto")
    if tuple(lp.shape) != (64, 64, 40):
        fail("grid log_prob: wrong shape")
    require_close(lp, want, "grid log_prob vs per-layer path", 1e-4, 1e-4)
    return -(-64 * 64 * 40 // 65536)  # chunks = kernel launches


# -- training: train_run against its plain version -----------------------------

def put(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)


def small_train_data(rng, n_cond):
    x = rng.normal(size=(137, 5)).astype(np.float32)
    th = (rng.uniform(-1, 2, size=(137, n_cond)).astype(np.float32)
          if n_cond else None)
    return dt.DataArrays.make(x, th, rng=0), x


def small_train_chains(data, x, device):
    """The kernel's op set at test size: every coupling kind, activation,
    clamp, bias-free nets, 2- to 4-layer nets, ActNorm, a permutation."""
    h16 = dict(hidden_dim_s=16, hidden_dim_t=16, device=device)
    h12 = dict(hidden_dim_s=12, hidden_dim_t=12, device=device)
    norm = lambda: dt.normalization_layer(x, -1.0, 1.0, device=device)  # noqa: E731
    layer = lambda mask, **kw: dt.coupling_layer(data, mask, **kw)      # noqa: E731
    return {
        "reference": [layer([0, 1, 2], **h16), layer([2, 3, 4], **h16),
                      layer([4, 0, 1], **h16), norm()],
        "nice": [layer([0, 1, 2], kind=dt.NICECouplingLayer, **h16),
                 layer([2, 3, 4], kind=dt.NICECouplingLayer, **h16), norm()],
        "joint": [layer([0, 1, 2], joint_conditioner=True, **h16),
                  layer([2, 3, 4], joint_conditioner=True, **h16), norm()],
        "nobias_tanh": [dt.coupling_block(
            data, [0, 2, 4], activation_s="tanh", activation_t="tanh",
            bias=False, **h12), norm()],
        "sigmoid_deep": [layer([0, 1, 2], activation_s="sigmoid",
                               activation_t="sigmoid", n_sublayers_s=3,
                               n_sublayers_t=1, **h12), norm()],
        "clamp": [layer([0, 1, 2], max_log_scale=0.1, **h16),
                  layer([2, 3, 4], max_log_scale=0.5, joint_conditioner=True,
                        **h16), norm()],
        "actnorm_permutation": [
            layer([0, 1, 2], **h12), dt.permutation_layer([3, 1, 4, 0, 2]),
            dt.actnorm_layer(x, device=device),
            layer([1, 2, 3], joint_conditioner=True, **h12), norm()],
    }


class TrainCase:
    """A folded chain on the card with its data split and a batch order."""

    def __init__(self, layers, data, device, rng, epochs=4,
                 batchsize=32):
        self.chain = numpy_weights_(dt.flow_chain(*layers), rng, 0.3)
        flow = dt.Flow(self.chain, data, device=device)
        (self.plan, _tc, self.tparams, self.masks, self.slots, self.cparams,
         _fold, self.unfold) = ft.chain_train_fold(self.chain)
        xt, tht = data.normalized_training_data(flow.metadata)
        xv, thv = data.normalized_validation_data(flow.metadata)
        n_cond = tht.shape[1]
        self.arrays = (put(xt, device), put(tht, device) if n_cond else None,
                       put(xv, device), put(thv, device) if n_cond else None)
        self.n_rows, self.batchsize = xt.shape[0], batchsize
        self.perms = np.stack([rng.permutation(self.n_rows)
                               for _ in range(epochs)])
        self.w = put(rng.uniform(0.3, 2.0, size=xt.shape[0]), device)
        self.wv = put(rng.uniform(0.3, 2.0, size=xv.shape[0]), device)
        self.zeros = [torch.zeros_like(p) for p in self.tparams]

    def run(self, fn, perms=None, state=None, **kw):
        tparams, mu, nu = state or (self.tparams, self.zeros, self.zeros)
        out = fn(self.plan, tparams, self.masks, self.slots, self.cparams,
                 mu, nu, *self.arrays,
                 self.perms if perms is None else perms,
                 batchsize=self.batchsize, **kw)
        torch.cuda.synchronize()
        return out


def require_runs_close(got, want, what, tol):
    """params, mu, nu, both histories, best snapshot, skips."""
    worst = 0.0
    for i, name in ((0, "params"), (1, "mu"), (2, "nu")):
        for k, (a, b) in enumerate(zip(got[i], want[i])):
            worst = max(worst, require_close(a, b, f"{what}: {name}[{k}]",
                                             **tol))
    for i, name in ((3, "train history"), (4, "valid history")):
        worst = max(worst, require_close(got[i], want[i], f"{what}: {name}",
                                         **tol))
    if (got[5] is None) != (want[5] is None):
        fail(f"{what}: best snapshot on one side only")
    if got[5] is not None:
        for k, (a, b) in enumerate(zip(got[5], want[5])):
            worst = max(worst, require_close(a, b, f"{what}: best[{k}]",
                                             **tol))
    if (got[6] is None) != (want[6] is None):
        fail(f"{what}: skips on one side only")
    if got[6] is not None and got[6].tolist() != want[6].tolist():
        fail(f"{what}: skips {got[6].tolist()} != {want[6].tolist()}")
    return worst


def check_train_small(rng, device):
    """train_run against fused_train_plain on the card, small runs: 4 epochs,
    137 rows (123 training rows: a ragged last batch), batch 32."""
    data, x = small_train_data(rng, 1)
    errs = {}
    for name, layers in small_train_chains(data, x, device).items():
        case = TrainCase(layers, data, device, rng)
        errs[name] = require_runs_close(
            case.run(tk.run_fused_train), case.run(tk.fused_train_plain),
            f"train_run {name}", TRAIN_TOL)

    data0, x0 = small_train_data(rng, 0)
    case = TrainCase(
        [dt.coupling_layer(data0, [0, 1, 2], hidden_dim_s=16,
                           hidden_dim_t=16, device=device),
         dt.coupling_layer(data0, [2, 3, 4], hidden_dim_s=16,
                           hidden_dim_t=16, device=device,
                           kind=dt.NICECouplingLayer),
         dt.normalization_layer(x0, -1.0, 1.0, device=device)],
        data0, device, rng)
    errs["n0"] = require_runs_close(
        case.run(tk.run_fused_train), case.run(tk.fused_train_plain),
        "train_run n = 0", TRAIN_TOL)

    ref = small_train_chains(data, x, device)["reference"]
    case = TrainCase(ref, data, device, rng, epochs=5)
    kw = dict(w=case.w, w_valid=case.wv, track_best=True, lr=3e-3, b1=0.85)
    one = case.run(tk.run_fused_train, **kw)
    errs["weighted_track_best"] = require_runs_close(
        one, case.run(tk.fused_train_plain, **kw),
        "train_run weighted + track_best", TRAIN_TOL)

    # two calls with carried state against one call, bit for bit
    n_batches = -(-case.n_rows // case.batchsize)
    a = case.run(tk.run_fused_train, perms=case.perms[:2], **kw)
    b = case.run(tk.run_fused_train, perms=case.perms[2:], state=a[:3],
                 count0=2 * n_batches, **kw)
    for i in (0, 1, 2):
        for u, v in zip(one[i], b[i]):
            if not torch.equal(u, v):
                fail("train_run: two calls with carried state differ from "
                     "one call")
    if not (torch.equal(one[3], torch.cat([a[3], b[3]]))
            and torch.equal(one[4], torch.cat([a[4], b[4]]))):
        fail("train_run: histories of two calls differ from one call")

    # the guard. NaN rows poison the batches that gather them: equal skips,
    # equal finite parameters, NaN full-split histories on both sides
    arrays = list(case.arrays)
    arrays[0] = arrays[0].clone()
    arrays[0][[5, 40, 77], 1] = float("nan")
    case.arrays = tuple(arrays)
    got = case.run(tk.run_fused_train, guard_nonfinite=True)
    want = case.run(tk.fused_train_plain, guard_nonfinite=True)
    skipped = int(got[6].sum())
    if skipped == 0 or got[6].tolist() != want[6].tolist():
        fail(f"train_run guard: skips {got[6].tolist()} vs plain "
             f"{want[6].tolist()}")
    for i in (0, 1, 2):
        for u, v in zip(got[i], want[i]):
            require_close(u, v, "train_run guard (NaN rows)", **TRAIN_TOL)
    if not bool(torch.isnan(got[3]).all()):
        fail("train_run guard: full-split NLL over NaN rows must be NaN")

    # the guard with an exploding learning rate: the first steps throw the
    # parameters far enough for exp(s) to overflow, every later batch is
    # skipped, and the parameters stay finite
    case = TrainCase(ref, data, device, rng)
    got = case.run(tk.run_fused_train, guard_nonfinite=True, lr=100.0)
    want = case.run(tk.fused_train_plain, guard_nonfinite=True, lr=100.0)
    exploded = int(got[6].sum())
    if exploded == 0 or got[6].tolist() != want[6].tolist():
        fail(f"train_run guard (lr 100): skips {got[6].tolist()} vs plain "
             f"{want[6].tolist()}")
    for p in got[0] + got[1] + got[2]:
        if not bool(torch.isfinite(p).all()):
            fail("train_run guard (lr 100): non-finite parameters")
    return errs, {"nan_rows": skipped, "lr_100": exploded}


# -- training: the main path ------------------------------------------------------

def baseline_data():
    here = os.path.dirname(os.path.abspath(__file__))
    dat = np.load(os.path.join(here, "tests", "fixtures", "datatest.npz"))
    return dt.DataArrays.make(dat["x"], dat["theta"], rng=0), dat


def baseline_flow(data, dat, device, seed):
    g = torch.Generator().manual_seed(seed)
    kw = dict(hidden_dim_s=16, hidden_dim_t=16, generator=g, device=device)
    return dt.Flow(dt.flow_chain(
        dt.coupling_layer(data, [0, 1, 2], **kw),
        dt.coupling_layer(data, [2, 3, 4], **kw),
        dt.coupling_layer(data, [4, 0, 1], **kw),
        dt.normalization_layer(dat["x"], -1.0, 1.0, device=device)),
        data, device=device)


def drive_training(device, tmp):
    """README / BASELINE config through train → evaluate → save_flow /
    load_flow with the optimizer state → 5 more epochs → sample."""
    data, dat = baseline_data()
    n_train = len(data.partition.training)
    n_batches = -(-n_train // TRAIN_BATCH)
    flow = baseline_flow(data, dat, device, SEED)

    tk.run_fused_train.launches = 0
    t0 = time.time()
    state = dt.train(flow, data, epochs=TRAIN_EPOCHS, batchsize=TRAIN_BATCH,
                     verbose=False,
                     generator=torch.Generator().manual_seed(SEED + 1))
    torch.cuda.synchronize()
    train_seconds = time.time() - t0
    launches = tk.run_fused_train.launches
    if flow.trained_path != "fused" or flow.fused_kernel_mode != "resident" \
            or flow.fused_decline_reason is not None:
        fail(f"train did not take the kernel: path {flow.trained_path}, "
             f"reason {flow.fused_decline_reason}")
    if launches != 1:
        fail(f"train launched train_run {launches} times, expected 1")
    tl, vl = np.asarray(flow.train_loss), np.asarray(flow.valid_loss)
    if tl.shape != (TRAIN_EPOCHS,) or vl.shape != (TRAIN_EPOCHS,) or \
            not (np.isfinite(tl).all() and np.isfinite(vl).all()):
        fail("train: histories are not 50 finite entries")
    if not vl[-1] < vl[0] or vl[-1] > 3.3:
        fail(f"train: valid NLL {vl[0]} -> {vl[-1]}, expected a decrease to "
             "at most 3.3")
    if state.count != TRAIN_EPOCHS * n_batches:
        fail(f"train: Adam count {state.count}")

    # the same run on the plain program, same weights, same batch order
    # (the permutations train_fused drew from that generator)
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED + 1),
                                TRAIN_EPOCHS, n_train)
    plain = baseline_flow(data, dat, device, SEED)
    t0 = time.time()
    state_p = dt.train(plain, data, epochs=TRAIN_EPOCHS,
                       batchsize=TRAIN_BATCH, verbose=False,
                       fused_kernel=False, _epoch_perms=perms)
    torch.cuda.synchronize()
    program_seconds = time.time() - t0
    if plain.trained_path != "torch" or state_p.count != state.count:
        fail("plain program: wrong path or Adam count")
    vlp = np.asarray(plain.valid_loss)
    tlp = np.asarray(plain.train_loss)
    # Two f32 trajectories (hand-derived backward in the kernel, autograd in
    # the program) agree to rounding at first and drift apart over 750 Adam
    # steps, which amplify rounding where a gradient is near 0. The gate is
    # therefore a short run of both paths from the same weights (4 epochs,
    # 60 steps): histories within 1e-4, parameters within 1e-3. Of the 50
    # epochs the first 3 history entries are held to 1e-4 and the NLL of all
    # 50 to 5e-2; the parameters' drift after 50 epochs is reported only.
    short = {}
    for name, fused in (("fused", True), ("torch", False)):
        f = baseline_flow(data, dat, device, SEED)
        dt.train(f, data, epochs=4, batchsize=TRAIN_BATCH, verbose=False,
                 fused_kernel=fused, _epoch_perms=perms[:4])
        if f.trained_path != name:
            fail(f"4-epoch run took {f.trained_path}, expected {name}")
        short[name] = f
    launches_short = tk.run_fused_train.launches - launches
    short_hist = float(max(
        np.abs(np.asarray(short["fused"].valid_loss)
               - np.asarray(short["torch"].valid_loss)).max(),
        np.abs(np.asarray(short["fused"].train_loss)
               - np.asarray(short["torch"].train_loss)).max()))
    short_leaf = max(float((a.detach() - b.detach()).abs().max())
                     for a, b in zip(ft.trainable_leaves(short["fused"].model),
                                     ft.trainable_leaves(short["torch"].model)))
    hist_early = float(max(np.abs(vl[:3] - vlp[:3]).max(),
                           np.abs(tl[:3] - tlp[:3]).max()))
    hist_all = float(max(np.abs(vl - vlp).max(), np.abs(tl - tlp).max()))
    leaf_err = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in zip(ft.trainable_leaves(flow.model),
                                   ft.trainable_leaves(plain.model)))
    if short_hist > 1e-4 or short_leaf > 1e-3 or hist_early > 1e-4 \
            or hist_all > 5e-2:
        fail(f"kernel and plain program disagree: 4 epochs histories "
             f"{short_hist}, parameters {short_leaf}; 50 epochs histories "
             f"{hist_early} (first 3) / {hist_all} (all)")

    # evaluate: the validation split reproduces the last history entry; a
    # data object with a test split gives a finite held-out NLL
    ev_valid = dt.evaluate(flow, data, "validation")
    if abs(ev_valid - vl[-1]) > 1e-4:
        fail(f"evaluate(validation) {ev_valid} != last valid NLL {vl[-1]}")
    split3 = dt.DataArrays.make(dat["x"], dat["theta"], f_training=0.6,
                                f_validation=0.1, rng=1)
    ev_test = dt.evaluate(flow, split3, "testing")
    if not np.isfinite(ev_test) or ev_test > 3.5:
        fail(f"evaluate(testing) = {ev_test}")

    # checkpoint with the optimizer state, resume for 5 epochs
    path = f"{tmp}/trained"
    dt.save_flow(path, flow, state)
    loaded, state_l = dt.load_flow(path, dt.adam(), device=device)
    if state_l.count != state.count or \
            loaded.train_loss != flow.train_loss:
        fail("load_flow did not restore the optimizer count or histories")
    for a, b in zip(state_l.mu + state_l.nu, state.mu + state.nu):
        if not torch.equal(a, b):
            fail("load_flow did not restore the Adam moments")
    state_c = dt.train(loaded, data, dt.adam(), state_l, epochs=5,
                       batchsize=TRAIN_BATCH, verbose=False,
                       generator=torch.Generator().manual_seed(SEED + 2))
    torch.cuda.synchronize()
    if loaded.trained_path != "fused" or \
            tk.run_fused_train.launches != launches + launches_short + 1:
        fail("the resumed run did not take the kernel")
    if state_c.count != state.count + 5 * n_batches or \
            len(loaded.valid_loss) != TRAIN_EPOCHS + 5 or \
            not np.isfinite(loaded.valid_loss[-5:]).all() or \
            loaded.valid_loss[-1] > vl[-1] + 0.05:
        fail(f"resumed run: count {state_c.count}, valid NLL "
             f"{loaded.valid_loss[-5:]}")

    # sample at θ = −1 through chain_sample: per-dim moments against the data
    # rows with θ = −1 (a flow at NLL ≈ 3.0 to 3.2 after 55 epochs; gates:
    # mean within 0.25 data-std, std within a factor 1.25)
    before = ck.run_chain_sample.launches
    with torch.no_grad():
        s = loaded.sample((50_000,), (-1.0,),
                          generator=torch.Generator().manual_seed(SEED + 3))
    torch.cuda.synchronize()
    if ck.run_chain_sample.launches != before + 1:
        fail("sample did not go through chain_sample")
    rows = dat["x"][dat["theta"][:, 0] == -1.0]
    s = s.double().cpu().numpy()
    dmean = np.abs(s.mean(0) - rows.mean(0)) / rows.std(0)
    ratio = s.std(0) / rows.std(0)
    if not np.isfinite(s).all() or dmean.max() > 0.25 or \
            ratio.max() > 1.25 or ratio.min() < 1 / 1.25:
        fail(f"sample moments at theta = -1: mean off by {dmean.tolist()} "
             f"data-std, std ratios {ratio.tolist()}")

    report = dict(
        train_seconds=train_seconds, program_seconds=program_seconds,
        valid_nll_first=float(vl[0]), valid_nll_last=float(vl[-1]),
        valid_nll_last_plain=float(vlp[-1]), adam_count=state.count,
        history_err_4_epoch_runs=short_hist,
        parameter_err_4_epoch_runs=short_leaf,
        history_err_first_3_epochs=hist_early, history_err_50_epochs=hist_all,
        parameter_drift_50_epochs=leaf_err, evaluate_validation=ev_valid,
        evaluate_testing=ev_test, resumed_valid_nll=loaded.valid_loss[-1],
        resumed_adam_count=state_c.count,
        sample_mean_err_in_data_std=dmean.tolist(),
        sample_std_ratio=ratio.tolist())
    return launches, report, (baseline_flow(data, dat, device, SEED), data,
                              perms)


def wide_stream(rng, device):
    """train() on the wide serving chain (d 32, n 8, 8 couplings of hidden
    256): past train_run's shared memory, inside train_stream's envelope, so
    the default routing takes the stream mode; the plain program on the same
    weights and batch order beside it, for its ms per step."""
    rows, batch, epochs = 4096, 256, 2
    x, th01 = data(rng, rows, D, N_COND, "cpu")
    arrays = dt.DataArrays.make(x.numpy(), th01.numpy(), rng=0)
    flow = dt.Flow(wide_chain(False, rng, device), arrays, device=device)
    plain = dt.Flow(copy.deepcopy(flow.model), arrays, device=device)
    n_train = len(arrays.partition.training)
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED), epochs,
                                n_train)
    tk.run_fused_train.launches = 0
    stk.run_fused_train_stream.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a decline warns
        dt.train(flow, arrays, epochs=epochs, batchsize=batch, verbose=False,
                 _epoch_perms=perms)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = stk.run_fused_train_stream.launches
    if flow.trained_path != "fused" or flow.fused_kernel_mode != "stream" \
            or launches != 1 or tk.run_fused_train.launches != 0:
        fail(f"wide chain: train took {flow.trained_path} / "
             f"{flow.fused_kernel_mode} with {launches} train_stream "
             f"launches ({flow.fused_decline_reason})")
    # the kernel alone on the same run, from the same starting weights
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(plain.model)
    sp = ft.fold_for_step(plain).step_plan
    xt, tht = arrays.normalized_training_data(plain.metadata)
    xt, tht = put(xt, device), put(tht, device)
    zeros = [torch.zeros_like(p) for p in tparams]
    kernel_ms = time_ms(lambda: stk.run_fused_train_stream(
        plan, tparams, masks, slots, cparams, zeros, zeros, xt, tht, perms,
        batchsize=batch, step_plan=sp), warmup=1, runs=3)
    tile, threads, shared, n_blocks, staged = stk.device_launch_shape(
        sp, batch)
    t0 = time.time()
    dt.train(plain, arrays, epochs=epochs, batchsize=batch, verbose=False,
             fused_kernel=False, _epoch_perms=perms)
    torch.cuda.synchronize()
    plain_seconds = time.time() - t0
    for f in (flow, plain):
        if not np.isfinite(f.valid_loss).all() or len(f.valid_loss) != 2:
            fail(f"wide chain: histories {f.train_loss} / {f.valid_loss}")
    # two f32 trajectories over 30 Adam steps: the gate of the long runs
    hist_err = float(np.abs(np.asarray(flow.valid_loss)
                            - np.asarray(plain.valid_loss)).max())
    if hist_err > 5e-2:
        fail(f"wide chain: validation NLL {flow.valid_loss} vs the plain "
             f"program's {plain.valid_loss}")
    steps = epochs * -(-n_train // batch)
    return dict(rows=rows, batchsize=batch, epochs=epochs, steps=steps,
                train_stream_launches=launches,
                train_stream_ms_per_step=1e3 * seconds / steps,
                kernel_alone_ms_per_step=kernel_ms / steps,
                plain_program_ms_per_step=1e3 * plain_seconds / steps,
                folded_parameters=sp.n_params, tile_rows=tile,
                threads=threads, shared_bytes=shared, blocks=n_blocks,
                parameters_staged=staged,
                valid_nll=flow.valid_loss, valid_nll_plain=plain.valid_loss,
                valid_history_err_vs_plain=hist_err)


def elu_decline(rng, device):
    """train() on a chain with an "elu" conditioner, outside both training
    kernels' envelopes: the default routing declines by name, with a
    RuntimeWarning, and the plain program trains it."""
    rows, batch = 4096, 256
    x, th01 = data(rng, rows, D, N_COND, "cpu")
    arrays = dt.DataArrays.make(x.numpy(), th01.numpy(), rng=0)
    x_ref = rng.normal(size=(512, D)).astype(np.float32)
    flow = dt.Flow(dt.flow_chain(
        dt.coupling_block(D, None, n=N_COND, hidden_dim_s=64, hidden_dim_t=64,
                          activation_s="elu", activation_t="elu",
                          device=device),
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device)), arrays,
        device=device)
    tk.run_fused_train.launches = 0
    stk.run_fused_train_stream.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dt.train(flow, arrays, epochs=1, batchsize=batch, verbose=False,
                 generator=torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    reason = flow.fused_decline_reason or ""
    if not any(issubclass(c.category, RuntimeWarning) and reason
               and reason in str(c.message) for c in caught):
        fail("elu chain: the decline raised no warning naming its reason")
    if flow.trained_path != "torch" or tk.run_fused_train.launches != 0 or \
            stk.run_fused_train_stream.launches != 0:
        fail("elu chain: train did not decline to the plain program")
    if "activation 'elu'" not in reason:
        fail(f"elu chain: decline reason does not name the activation: "
             f"{reason}")
    if not np.isfinite(flow.valid_loss).all() or len(flow.valid_loss) != 1:
        fail("elu chain: plain program histories")
    return dict(reason=reason)


def train_kernel_row(flow, dataset, perms, launches, err_small, device, card):
    """The {"kernels": ...} entry of train_run at the main path's shapes:
    ``flow`` holds the weights the main path started from, ``perms`` its
    batch order. The kernel is held against its plain version there, then
    timed beside it and beside the plain program."""
    chain = flow.model
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(chain)
    xt, tht = dataset.normalized_training_data(flow.metadata)
    xv, thv = dataset.normalized_validation_data(flow.metadata)
    arrays = (put(xt, device), put(tht, device), put(xv, device),
              put(thv, device))
    d, n_cond = xt.shape[1], tht.shape[1]
    n_train, n_valid = xt.shape[0], xv.shape[0]
    # the plan and, through the wrapper, the thread count that train() uses
    packed = tk.pack_train_plan(plan, tparams, masks, slots, cparams, d,
                                n_cond, TRAIN_BATCH)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros)
    kw = dict(batchsize=TRAIN_BATCH, guard_nonfinite=True)

    def both(p):
        got = tk.run_fused_train(*head, *arrays, p, packed=packed, **kw)
        want = tk.fused_train_plain(*head, *arrays, p, **kw)
        torch.cuda.synchronize()
        return got, want

    # the gate: 4 epochs (60 Adam steps), where the two differ by the order
    # of their sums only; parameters, moments, both histories, skip counts
    err_main = require_runs_close(*both(perms[:4]),
                                  "train_run at the main path's shape",
                                  TRAIN_TOL)
    # reported, not gated: how far that rounding has grown after all epochs
    got, want = both(perms)
    drift = {name: max(float((a - b).abs().max())
                       for a, b in zip(got[i], want[i]))
             for i, name in ((0, "params"), (1, "mu"), (2, "nu"))}
    drift["train_history"] = float((got[3] - want[3]).abs().max())
    drift["valid_history"] = float((got[4] - want[4]).abs().max())
    if got[6].tolist() != want[6].tolist():
        fail("train_run at the main path's shape: skip counts differ")

    del kw["guard_nonfinite"]
    ms = time_ms(lambda: tk.run_fused_train(
        *head, *arrays, perms, packed=packed, **kw), warmup=1, runs=5)
    full = dict(kw, count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                track_best=False, w=None, w_valid=None, guard_nonfinite=False,
                packed=packed)
    by_threads = {t: time_ms(lambda: tk._launch_train_run(
        *head, *arrays, perms, threads=t, **full), warmup=0, runs=3)
        for t in (256, 512, 1024)}
    plain = time_ms(lambda: tk.fused_train_plain(
        *head, *arrays, perms, **kw), warmup=0, runs=3)

    epochs = perms.shape[0]

    def program():
        f = baseline_flow(dataset, {"x": dataset.x}, device, SEED)
        dt.train(f, dataset, epochs=epochs, batchsize=TRAIN_BATCH,
                 verbose=False, fused_kernel=False, _epoch_perms=perms)
    program_ms = time_ms(program, warmup=0, runs=3)

    # the bound: every product the run needs — per training row the forward
    # and two backward products per layer, per evaluated row the forward —
    # at the layers' own shapes, over the f32 rate; against every input read
    # once and every output written once
    fwd = needed_flops_per_row(chain)
    flops = epochs * (3 * n_train + (n_train + n_valid)) * fwd
    n_pad = -(-n_train // TRAIN_BATCH) * TRAIN_BATCH
    nbytes = 4 * ((n_train + n_valid) * (d + n_cond) + epochs * n_pad
                  + 7 * packed.n_params + packed.flat_consts.numel()
                  + packed.prog.numel() + 3 * epochs)
    b_ms, by = bound_ms(flops, nbytes)
    say(phase="train_times", card=card, epochs=epochs,
        train_run_ms=ms, train_run_ms_per_epoch=ms / epochs,
        train_run_ms_by_threads=by_threads,
        default_threads=tk._block_threads(packed),
        plain_version_ms=plain, plain_program_ms=program_ms,
        plain_program_ms_per_epoch=program_ms / epochs,
        shared_bytes=packed.shared_bytes, folded_parameters=packed.n_params,
        max_abs_err_4_epochs_vs_plain_version=err_main,
        drift_50_epochs_vs_plain_version=drift)
    return {
        "name": "train_run", "route": "cuda",
        "source": "densityflows_tpu_torch/csrc/train_kernels.cu",
        "replaces": "densityflows_tpu/ops/pallas_train.py:514",
        "launches": launches, "max_abs_err": max(err_main, err_small),
        "max_abs_err_main_shape_4_epochs": err_main,
        "max_abs_err_small_cases": err_small, "tolerance": TRAIN_TOL,
        "shape": f"{epochs} epochs x {n_pad // TRAIN_BATCH} batches of "
                 f"{TRAIN_BATCH}, {n_train} training + {n_valid} validation "
                 f"rows, d {d}, theta {n_cond}, 3 split couplings hidden 16 "
                 f"+ affine ({packed.n_params} folded parameters); held "
                 f"against the plain version over the first 4 epochs",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "program_ms": program_ms,
        "needed_flops": flops, "needed_bytes": nbytes,
        "ms_per_epoch": ms / epochs,
        "program_ms_per_epoch": program_ms / epochs,
    }


# -- step_grads against its plain version ------------------------------------------

def step_plan_of(case, d, n):
    return sk.StepPlan(case.plan, case.tparams, case.masks, case.slots,
                       case.cparams, d, n)


def require_step_close(got, want, what):
    """Packed (gradient, loss) buffers: 1e-4 absolute on every entry."""
    return require_close(got, want, what, **STEP_TOL)


def plain_packed(sp, tparams, x, th, mask, denom=None):
    loss, grads = sk.step_grads_plain(sp.plan, tparams, sp.masks,
                                      sp.mask_slots, sp.cparams, x, th, mask,
                                      denom=denom)
    return torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])


def check_step_case(case, name, rng, device):
    """One folded chain: a weighted batch of an odd row count with padded
    rows and a fully masked tile, at several tiles and block counts, with
    the parameters in shared memory and in device memory, against the plain
    version; two launches bit for bit; an explicit denominator;
    off-support gradient entries exactly 0; a NaN row; and the gradients
    against autograd of the per-layer path."""
    x, th = case.arrays[0], case.arrays[1]
    rows, d = x.shape
    n = th.shape[1] if th is not None else 0
    sp = step_plan_of(case, d, n)
    flat = sp.flatten(case.tparams)
    w = rng.uniform(0.2, 2.0, size=rows) * (np.arange(rows) < rows - 5)
    w[8:16] = 0.0                      # a whole tile of 8 rows masked out
    mask = put(w, device)
    want = plain_packed(sp, case.tparams, x, th, mask)
    worst = 0.0
    runs = {}
    # tiles, grids and both residencies of the parameters (shared memory,
    # device memory)
    for tile, n_blocks, stage in ((None, None, None), (8, 3, True),
                                  (8, 3, False), (16, None, False),
                                  (64, None, True), (1, None, None)):
        kw = dict(tile=tile, n_blocks=n_blocks, stage=stage)
        got = sp.loss_and_grads(flat, x, th, mask, **kw)
        again = sp.loss_and_grads(flat, x, th, mask, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"step_grads {name}: two launches differ ({kw})")
        worst = max(worst, require_step_close(
            got, want, f"step_grads {name} {kw}"))
        runs[tile] = got
    dense = torch.cat([(torch.ones_like(p) if s is None else sp.masks[s]
                        ).reshape(-1) for p, s in
                       zip(case.tparams, sp.mask_slots)])
    if bool((runs[None][:-1][dense == 0] != 0).any()):
        fail(f"step_grads {name}: a masked gradient entry is not 0")
    denom = 2.5 * float(mask.sum())
    worst = max(worst, require_step_close(
        sp.loss_and_grads(flat, x, th, mask, denom=denom),
        plain_packed(sp, case.tparams, x, th, mask, denom=denom),
        f"step_grads {name} explicit denominator"))

    # autograd of the per-layer path on the same batch, leaf by leaf
    loss_a, _leaves, grads_a = _loss_and_grads(
        case.chain, dt.StandardNormal(d), x,
        th if th is not None else x.new_zeros(rows, 0), mask)
    unfolded = case.unfold(sp.unflatten(runs[None][:-1]))
    worst = max(worst, require_close(
        runs[None][-1], loss_a, f"step_grads {name}: loss vs autograd",
        **STEP_TOL))
    for k, (a, b) in enumerate(zip(unfolded, grads_a)):
        if b.numel():
            worst = max(worst, require_close(
                a, b, f"step_grads {name}: leaf {k} vs autograd",
                **STEP_TOL))

    # a NaN row poisons the loss on both sides, in the same entries, and
    # the masked entries stay exactly 0 (a select, not a product)
    xn = x.clone()
    xn[3, 1] = float("nan")
    got = sp.loss_and_grads(flat, xn, th, mask)
    want_n = plain_packed(sp, case.tparams, xn, th, mask)
    torch.cuda.synchronize()
    if not bool(torch.isnan(got[-1])) or not bool(torch.isnan(want_n[-1])):
        fail(f"step_grads {name}: a NaN row must give a NaN loss")
    if not torch.equal(torch.isnan(got), torch.isnan(want_n)):
        fail(f"step_grads {name}: NaN entries differ from the plain version")
    if bool((got[:-1][dense == 0] != 0).any()):
        fail(f"step_grads {name}: NaN row: a masked entry is not 0")
    return worst


def check_step_small(rng, device):
    """step_grads against step_grads_plain on the card, the small chains of
    the train smoke (123 rows: no multiple of any tile)."""
    data, x = small_train_data(rng, 1)
    errs = {}
    for name, layers in small_train_chains(data, x, device).items():
        errs[name] = check_step_case(TrainCase(layers, data, device, rng),
                                     name, rng, device)
    data0, x0 = small_train_data(rng, 0)
    case = TrainCase(
        [dt.coupling_layer(data0, [0, 1, 2], hidden_dim_s=16,
                           hidden_dim_t=16, device=device),
         dt.actnorm_layer(x0, device=device),
         dt.coupling_layer(data0, [2, 3, 4], hidden_dim_s=16,
                           hidden_dim_t=16, device=device,
                           kind=dt.NICECouplingLayer),
         dt.normalization_layer(x0, -1.0, 1.0, device=device)],
        data0, device, rng)
    errs["n0_actnorm"] = check_step_case(case, "n = 0", rng, device)
    return errs


# -- train_stream against its plain version ---------------------------------------

def stream_run(case, fn, perms=None, state=None, **kw):
    """``fn`` (``run_fused_train_stream`` or its plain version) on a
    TrainCase's training split, with the per-step losses."""
    tparams, mu, nu = state or (case.tparams, case.zeros, case.zeros)
    out = fn(case.plan, tparams, case.masks, case.slots, case.cparams, mu, nu,
             case.arrays[0], case.arrays[1],
             case.perms if perms is None else perms,
             batchsize=case.batchsize, with_losses=True, **kw)
    torch.cuda.synchronize()
    return out


def require_stream_close(got, want, what, tol=TRAIN_TOL):
    """params, mu, nu, snapshots and per-step losses (NaN where the other
    side has NaN), skips exactly."""
    worst = 0.0
    for i, name in ((0, "params"), (1, "mu"), (2, "nu"), (3, "snapshots")):
        for k, (a, b) in enumerate(zip(got[i], want[i])):
            worst = max(worst, require_close(a, b, f"{what}: {name}[{k}]",
                                             **tol))
    if (got[4] is None) != (want[4] is None) or (
            got[4] is not None and got[4].tolist() != want[4].tolist()):
        fail(f"{what}: skips {got[4]} != {want[4]}")
    nan = torch.isnan(want[5])
    if not torch.equal(torch.isnan(got[5]), nan):
        fail(f"{what}: NaN losses at other steps than the plain version's")
    return max(worst, require_close(got[5][~nan], want[5][~nan],
                                    f"{what}: losses", **tol))


def same_bits(a, b):
    """Two stream runs: every tensor equal bit for bit (NaN where NaN)."""
    def flat(out):
        return [t for group in out[:4] for t in group] + [
            t for t in out[4:] if t is not None]
    return all(torch.equal(torch.nan_to_num(u), torch.nan_to_num(v))
               and torch.equal(torch.isnan(u), torch.isnan(v))
               for u, v in zip(flat(a), flat(b)))


def check_stream_small(rng, device):
    """train_stream against fused_train_stream_plain on the card: the small
    chains of the train smoke, 4 epochs of batch 32 over 123 rows (a ragged
    last batch; every other case weighted), n = 0; two launches bit for bit;
    fewer blocks than tiles; one call against two chunked calls bit for bit;
    the guard on NaN rows; and on the BASELINE config train_stream against
    train_run over 4 epochs (parameters, moments, histories)."""
    data, x = small_train_data(rng, 1)
    errs = {}
    for i, (name, layers) in enumerate(
            small_train_chains(data, x, device).items()):
        case = TrainCase(layers, data, device, rng)
        kw = dict(w=case.w) if i % 2 else {}
        errs[name] = require_stream_close(
            stream_run(case, stk.run_fused_train_stream, **kw),
            stream_run(case, stk.fused_train_stream_plain, **kw),
            f"train_stream {name}")
    data0, x0 = small_train_data(rng, 0)
    case = TrainCase(
        [dt.coupling_layer(data0, [0, 1, 2], hidden_dim_s=16,
                           hidden_dim_t=16, device=device),
         dt.actnorm_layer(x0, device=device),
         dt.coupling_layer(data0, [2, 3, 4], hidden_dim_s=16,
                           hidden_dim_t=16, device=device,
                           kind=dt.NICECouplingLayer),
         dt.normalization_layer(x0, -1.0, 1.0, device=device)],
        data0, device, rng)
    errs["n0_actnorm"] = require_stream_close(
        stream_run(case, stk.run_fused_train_stream),
        stream_run(case, stk.fused_train_stream_plain), "train_stream n = 0")

    ref = small_train_chains(data, x, device)["reference"]
    case = TrainCase(ref, data, device, rng)
    kw = dict(w=case.w, guard_nonfinite=True, lr=3e-3, b1=0.85)
    one = stream_run(case, stk.run_fused_train_stream, **kw)
    if not same_bits(one, stream_run(case, stk.run_fused_train_stream, **kw)):
        fail("train_stream: two launches differ")
    want = stream_run(case, stk.fused_train_stream_plain, **kw)
    for n_blocks in (1, 3):
        errs[f"blocks_{n_blocks}"] = require_stream_close(
            stream_run(case, stk.run_fused_train_stream, n_blocks=n_blocks,
                       **kw), want, f"train_stream on {n_blocks} block(s)")
    n_batches = -(-case.n_rows // case.batchsize)
    a = stream_run(case, stk.run_fused_train_stream, perms=case.perms[:2],
                   **kw)
    b = stream_run(case, stk.run_fused_train_stream, perms=case.perms[2:],
                   state=a[:3], count0=2 * n_batches - int(a[4].sum()), **kw)
    chained = (b[0], b[1], b[2], [torch.cat([u, v]) for u, v in
                                  zip(a[3], b[3])],
               torch.cat([a[4], b[4]]), torch.cat([a[5], b[5]]))
    if not same_bits(one, chained):
        fail("train_stream: two chunked calls differ from one call")

    # the guard: NaN rows poison the batches that gather them
    arrays = list(case.arrays)
    arrays[0] = arrays[0].clone()
    arrays[0][[5, 40, 77], 1] = float("nan")
    case.arrays = tuple(arrays)
    got = stream_run(case, stk.run_fused_train_stream, guard_nonfinite=True)
    want = stream_run(case, stk.fused_train_stream_plain,
                      guard_nonfinite=True)
    skipped = int(got[4].sum())
    if skipped == 0:
        fail("train_stream guard: no step was skipped")
    errs["guard"] = require_stream_close(got, want, "train_stream guard")

    # BASELINE: train_stream against train_run, 4 epochs of batch 64
    data_b, dat = baseline_data()
    flow = baseline_flow(data_b, dat, device, SEED)
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(flow.model)
    xt, tht = data_b.normalized_training_data(flow.metadata)
    xv, thv = data_b.normalized_validation_data(flow.metadata)
    xt, tht, xv, thv = (put(a, device) for a in (xt, tht, xv, thv))
    perms = np.stack([rng.permutation(xt.shape[0]) for _ in range(4)])
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros)
    run = tk.run_fused_train(*head, xt, tht, xv, thv, perms,
                             batchsize=TRAIN_BATCH)
    strm = stk.run_fused_train_stream(*head, xt, tht, perms,
                                      batchsize=TRAIN_BATCH)
    hist = [stk.eval_snapshots(strm[3], cparams, xs, ths, None, plan=plan)
            for xs, ths in ((xt, tht), (xv, thv))]
    torch.cuda.synchronize()
    worst = 0.0
    for i, name in ((0, "params"), (1, "mu"), (2, "nu")):
        for k, (u, v) in enumerate(zip(strm[i], run[i])):
            worst = max(worst, require_close(
                u, v, f"train_stream vs train_run: {name}[{k}]", **TRAIN_TOL))
    for i, name in ((0, "train history"), (1, "valid history")):
        worst = max(worst, require_close(
            hist[i], run[3 + i], f"train_stream vs train_run: {name}",
            **TRAIN_TOL))
    errs["baseline_vs_train_run"] = worst
    return errs, {"nan_rows": skipped}


# -- streaming: the main path of the step kernel ---------------------------------

def med_data(rng):
    """2^20 training rows and 2^14 validation rows whose law depends on the
    conditions: x = z * (0.5 + theta.A) + theta.B, z ~ N(0, I)."""
    d, n = MED["d"], MED["n"]
    a = rng.uniform(0.0, 0.5, size=(n, d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)

    def draw(rows):
        th = rng.uniform(-1.0, 2.0, size=(rows, n)).astype(np.float32)
        z = rng.standard_normal(size=(rows, d), dtype=np.float32)
        return z * (0.5 + np.abs(th) @ a) + th @ b, th

    (x, th), (xv, thv) = draw(MED["rows"]), draw(MED["valid"])
    return x, th, xv, thv


def med_flow(x_ref, th, device, seed):
    """benchmarks/step_kernel_probe.py "med": d 16, n 4, three couplings on
    range(8) / range(8, 16) / range(8) with hidden 64, a normalization
    layer; weights from numpy_weights_."""
    d, n, h = MED["d"], MED["n"], MED["hidden"]
    kw = dict(n=n, hidden_dim_s=h, hidden_dim_t=h, device=device)
    chain = dt.flow_chain(
        dt.coupling_layer(d, list(range(d // 2)), **kw),
        dt.coupling_layer(d, list(range(d // 2, d)), **kw),
        dt.coupling_layer(d, list(range(d // 2)), **kw),
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))
    numpy_weights_(chain, np.random.default_rng(seed), 0.1)
    meta = dt.MetaData("med", d, n, th.min(0), th.max(0))
    return dt.Flow(chain, meta, device=device)


def stream50k_rows(rng):
    """50,000 training rows and 5,000 validation rows drawn apart."""
    def draw(rows):
        return (rng.normal(size=(rows, 5)).astype(np.float32),
                rng.uniform(-1, 2, size=(rows, 1)).astype(np.float32))

    (x, th), (xv, thv) = draw(STREAM50K["rows"]), draw(STREAM50K["valid"])
    return x, th, xv, thv


def first_steps_against_plain(make_flow, x, th, batch, steps, device):
    """The first ``steps`` batches of the loader through the step kernel +
    folded Adam and through the plain step (autograd + Adam), from the same
    weights: per-step losses at 1e-4, parameters at 1e-3."""
    fused, plain = make_flow(), make_flow()
    md = fused.metadata
    folded = ft.fold_for_step(fused)
    sp = folded.step_plan
    flat_p = sp.flatten(folded.tparams)
    fstate = _fold_adam_state(folded, None)
    step_k = dt.make_fused_step_fn(None, sp)
    optimizer = dt.adam()
    step_p = dt.make_train_step(optimizer)
    state_p = optimizer.init(ft.trainable_leaves(plain.model))
    losses = [[], []]
    loader = dt.StreamingLoader(x, th, batchsize=batch, seed=SEED)
    batches = loader.epoch(0)
    for _ in range(steps):
        xb, thb, mask = next(batches)
        thb = dt.normalize_input(thb, np.asarray(md.theta_min, np.float32),
                                 np.asarray(md.theta_max, np.float32))
        xb, thb, mask = put(xb, device), put(thb, device), put(mask, device)
        flat_p, fstate, loss = step_k(flat_p, fstate, xb, thb, mask)
        losses[0].append(loss)
        _, state_p, loss = step_p(plain.model, state_p, plain.base, xb, thb,
                                  mask)
        losses[1].append(loss)
    batches.close()
    torch.cuda.synchronize()
    loss_err = require_close(torch.stack(losses[0]), torch.stack(losses[1]),
                             "first steps: losses vs the plain step", 0.0,
                             1e-4)
    leaf_err = 0.0
    for k, (a, b) in enumerate(zip(folded.unfold(sp.unflatten(flat_p)),
                                   ft.trainable_leaves(plain.model))):
        leaf_err = max(leaf_err, require_close(
            a, b.detach(), f"first steps: leaf {k} vs the plain step", 0.0,
            1e-3))
    if fstate.count != steps or state_p.count != steps:
        fail("first steps: Adam counts")
    return loss_err, leaf_err


def drive_streaming(name, make_flow, x, th, xv, thv, cfg, device):
    """``train_streaming`` on the step kernel: native loader, launch count,
    falling train NLL, the final validation NLL against ``flow.log_prob``,
    the first 32 steps against the plain step; then the plain step on the
    same loader for one epoch, for its rate."""
    if not native.native_available():
        fail("the native host loader did not build")
    batch, epochs = cfg["batch"], cfg["epochs"]
    n_batches = -(-x.shape[0] // batch)
    flow = make_flow()
    sk.run_fused_grads.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a decline warns
        state = dt.train_streaming(flow, x, th, epochs=epochs,
                                   batchsize=batch, seed=SEED,
                                   valid_data=(xv, thv), verbose=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = sk.run_fused_grads.launches
    if flow.trained_path != "fused-step" or flow.fused_decline_reason:
        fail(f"{name}: train_streaming took {flow.trained_path} "
             f"({flow.fused_decline_reason})")
    if launches != n_batches * epochs:
        fail(f"{name}: {launches} step_grads launches, expected "
             f"{n_batches} batches x {epochs} epochs")
    if state.count != launches:
        fail(f"{name}: Adam count {state.count}")
    tl, vl = np.asarray(flow.train_loss), np.asarray(flow.valid_loss)
    if tl.shape != (epochs,) or vl.shape != (epochs,) or \
            not (np.isfinite(tl).all() and np.isfinite(vl).all()):
        fail(f"{name}: histories {tl} / {vl}")
    if not bool((np.diff(tl) < 0).all()):
        fail(f"{name}: train NLL does not fall epoch over epoch: {tl}")
    with torch.no_grad():
        lp = flow.log_prob(put(xv, device), put(thv, device))
    nll = float(-lp.mean())
    if abs(nll - vl[-1]) > 1e-4:
        fail(f"{name}: final validation NLL {vl[-1]} != -mean log_prob "
             f"{nll}")
    for p in flow.model.parameters():
        if not bool(torch.isfinite(p).all()):
            fail(f"{name}: non-finite parameters after streaming")

    loss_err, leaf_err = first_steps_against_plain(make_flow, x, th, batch,
                                                   32, device)

    plain = make_flow()
    torch.cuda.synchronize()
    t0 = time.time()
    dt.train_streaming(plain, x, th, epochs=1, batchsize=batch, seed=SEED,
                       verbose=False, fused_kernel=False)
    torch.cuda.synchronize()
    plain_seconds = time.time() - t0
    if plain.trained_path != "torch" or \
            sk.run_fused_grads.launches != launches + 32:
        fail(f"{name}: the plain streaming run took {plain.trained_path}")
    # two f32 trajectories over a whole epoch of Adam steps: the gate of the
    # 50-epoch train_run comparison
    if abs(plain.train_loss[0] - tl[0]) > 5e-2:
        fail(f"{name}: first-epoch train NLL {tl[0]} vs the plain step's "
             f"{plain.train_loss[0]}")
    steps = launches
    report = dict(
        rows=int(x.shape[0]), batchsize=batch, epochs=epochs, steps=steps,
        seconds=seconds, steps_per_s=steps / seconds,
        rows_per_s=epochs * x.shape[0] / seconds,
        ms_per_step=1e3 * seconds / steps,
        train_nll=tl.tolist(), valid_nll=vl.tolist(),
        valid_nll_vs_log_prob=abs(nll - float(vl[-1])),
        first_32_steps_loss_err=loss_err, first_32_steps_param_err=leaf_err,
        plain_step_seconds_one_epoch=plain_seconds,
        plain_step_steps_per_s=n_batches / plain_seconds,
        plain_step_rows_per_s=x.shape[0] / plain_seconds,
        plain_step_ms_per_step=1e3 * plain_seconds / n_batches,
        plain_step_first_epoch_train_nll=plain.train_loss[0])
    return launches, report, flow


def step_time_split(make_flow, x, th, cfg, step_ms, device):
    """Where a streaming step's time goes, each piece timed alone at the
    path's shapes: the loader (host), the staging copy, the two kernels of
    ``step_grads``, the denominator and Adam; what is left of the measured
    step is the host's gap."""
    from densityflows_tpu_torch.data_stream import _Stager

    batch = cfg["batch"]
    flow = make_flow()
    folded = ft.fold_for_step(flow)
    sp = folded.step_plan
    flat_p = sp.flatten(folded.tparams)
    fstate = _fold_adam_state(folded, None)
    loader = dt.StreamingLoader(x, th, batchsize=batch, seed=SEED)
    n_probe = min(256, loader.batches_per_epoch)
    t0 = time.time()
    batches = loader.epoch(0)
    host = [next(batches) for _ in range(n_probe)]
    loader_ms = 1e3 * (time.time() - t0) / n_probe
    batches.close()

    stage = _Stager(device, batch, x.shape[1], th.shape[1])
    torch.cuda.synchronize()
    t0 = time.time()
    for xb, thb, mask in host:
        staged = stage(xb, thb, mask)
    stage_host_ms = 1e3 * (time.time() - t0) / n_probe
    torch.cuda.synchronize()
    xb, thb, mask = staged
    copy_ms = time_ms(lambda: stage(*host[0]), runs=15)

    launcher = sp.launcher(batch)
    den = mask.sum().reshape(1)
    buf = torch.empty(sp.n_params + 1, device=device)

    def phase(which):
        return lambda: launcher(sk._library_launch, flat_p, xb, thb, mask,
                                denom=den, out=buf, phases=which)

    kernel_ms = time_ms(lambda: sp.loss_and_grads(flat_p, xb, thb, mask),
                        runs=15)
    tiles_ms = time_ms(phase(1), runs=15)
    reduce_ms = time_ms(phase(2), runs=15)
    out = sp.loss_and_grads(flat_p, xb, thb, mask)
    denom_ms = time_ms(lambda: mask.sum(), runs=15)
    adam_ms = time_ms(lambda: _folded_adam_(
        flat_p, fstate, out[:sp.n_params],
        dict(lr=0.0, b1=0.9, b2=0.999, eps=1e-8)), runs=15)

    # the device's side of a step alone: kernel + Adam on a resident batch
    step = dt.make_fused_step_fn(None, sp, lr=0.0)

    def many():
        for _ in range(100):
            step(flat_p, fstate, xb, thb, mask)
    device_step_ms = time_ms(many, warmup=1, runs=5) / 100
    device_ms = copy_ms + kernel_ms + denom_ms + adam_ms
    return dict(
        tile_rows=launcher.tile, blocks=launcher.n_blocks,
        threads=launcher.threads, shared_bytes=launcher.shared_bytes,
        parameters_in_shared_memory=launcher.staged,
        folded_parameters=sp.n_params,
        partial_bytes=4 * launcher.partial.numel(),
        loader_ms_per_batch=loader_ms, staging_host_ms=stage_host_ms,
        copy_ms=copy_ms, kernel_ms=kernel_ms, kernel_tiles_ms=tiles_ms,
        kernel_reduction_ms=reduce_ms, denominator_ms=denom_ms,
        adam_ms=adam_ms, device_sum_ms=device_ms,
        resident_batch_step_ms=device_step_ms,
        measured_step_ms=step_ms, host_gap_ms=step_ms - device_ms,
        kernel_share_of_step=kernel_ms / step_ms)


def drive_mesh(device, tmp):
    """``train(mesh=...)`` on a one-rank NCCL group at the README / BASELINE
    config: the step-kernel program, held against the single-device plain
    program on the same batch order (histories 1e-4)."""
    import torch.distributed as dist

    dt.distributed_init(f"file://{tmp}/rendezvous", 1, 0, backend="nccl")
    try:
        mesh = dt.make_mesh()
        if mesh.group is None or mesh.size != 1:
            fail(f"mesh: {mesh}")
        data, dat = baseline_data()
        n_train = len(data.partition.training)
        n_batches = -(-n_train // TRAIN_BATCH)
        perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED + 5),
                                    MESH_EPOCHS, n_train)
        flow = baseline_flow(data, dat, device, SEED)
        sk.run_fused_grads.launches = 0
        t0 = time.time()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            state = dt.train(flow, data, epochs=MESH_EPOCHS,
                             batchsize=TRAIN_BATCH, verbose=False, mesh=mesh,
                             _epoch_perms=perms)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = sk.run_fused_grads.launches
        if flow.trained_path != "fused-step-mesh":
            fail(f"train(mesh=...) took {flow.trained_path} "
                 f"({flow.fused_decline_reason})")
        if launches != MESH_EPOCHS * n_batches or state.count != launches:
            fail(f"train(mesh=...): {launches} launches, Adam count "
                 f"{state.count}")
        # once more, now that the first collectives have set the
        # communicator up: the steady time of a step (with the per-epoch
        # evaluations, fold and unfold of the call in it)
        again = baseline_flow(data, dat, device, SEED)
        torch.cuda.synchronize()
        t0 = time.time()
        dt.train(again, data, epochs=MESH_EPOCHS, batchsize=TRAIN_BATCH,
                 verbose=False, mesh=mesh, _epoch_perms=perms)
        torch.cuda.synchronize()
        steady_seconds = time.time() - t0
        if again.train_loss != flow.train_loss:
            fail("train(mesh=...): two runs from the same weights differ")
        # the plain data-parallel program on the same group
        dp = baseline_flow(data, dat, device, SEED)
        t0 = time.time()
        dt.train(dp, data, epochs=MESH_EPOCHS, batchsize=TRAIN_BATCH,
                 verbose=False, mesh=mesh, fused_kernel=False,
                 _epoch_perms=perms)
        torch.cuda.synchronize()
        dp_seconds = time.time() - t0
    finally:
        dist.destroy_process_group()
    plain = baseline_flow(data, dat, device, SEED)
    dt.train(plain, data, epochs=MESH_EPOCHS, batchsize=TRAIN_BATCH,
             verbose=False, fused_kernel=False, _epoch_perms=perms)
    torch.cuda.synchronize()
    errs = {}
    for name, other in (("step_kernel_program", flow),
                        ("plain_dp_program", dp)):
        errs[name] = float(max(
            np.abs(np.asarray(other.train_loss)
                   - np.asarray(plain.train_loss)).max(),
            np.abs(np.asarray(other.valid_loss)
                   - np.asarray(plain.valid_loss)).max()))
        if errs[name] > 1e-4:
            fail(f"train(mesh=...) {name}: histories differ from the "
                 f"single-device plain program by {errs[name]}")
    if dp.trained_path != "torch":
        fail("the plain data-parallel program: wrong path")
    leaf_err = max(float((a.detach() - b.detach()).abs().max())
                   for a, b in zip(ft.trainable_leaves(flow.model),
                                   ft.trainable_leaves(plain.model)))
    if leaf_err > 1e-3:
        fail(f"train(mesh=...): parameters differ from the single-device "
             f"plain program by {leaf_err}")
    return launches, dict(
        epochs=MESH_EPOCHS, batchsize=TRAIN_BATCH, backend="nccl",
        world_size=1, first_call_seconds=seconds,
        steady_call_seconds=steady_seconds,
        steady_ms_per_step=1e3 * steady_seconds / launches,
        plain_dp_program_ms_per_step=1e3 * dp_seconds / launches,
        history_err_vs_single_device_plain=errs,
        parameter_err_vs_single_device_plain=leaf_err,
        valid_nll=flow.valid_loss)


def step_tile_sweep(sp, flat, d, n, batches, device):
    """``step_grads`` timed over row tiles, grids and residencies at several
    batch sizes: per ``batch`` and ``tile x blocks`` (``s`` suffix: the
    parameters staged in shared memory) the two kernels together, the tile
    kernel alone and the reduction alone, each over launches back to back
    (ms, CUDA events). Grids: one block per tile, and fewer blocks that take
    several tiles each in turn. Every tiling must give the first one's
    result (1e-4 absolute + relative)."""
    rng = np.random.default_rng(SEED + 11)
    out = {}
    for batch in batches:
        x, th = data(rng, batch, d, n, device)
        mask = torch.ones(batch, device=device)
        den = mask.sum().reshape(1)
        buf = torch.empty(sp.n_params + 1, device=device)
        first, by_tiling = None, {}
        for tile in (4, 8, 16, 32, 64):
            if tile > batch or sp.shared_bytes(tile) > sk.MAX_SHARED_BYTES:
                continue
            n_tiles = -(-batch // tile)
            for stage in sorted({False, sp.stage_fits(tile)}):
                for n_blocks in sorted({n_tiles, max(1, n_tiles // 2),
                                        max(1, n_tiles // 4),
                                        min(n_tiles, 528), min(n_tiles, 132),
                                        min(n_tiles, 66)}, reverse=True):
                    launcher = sp.launcher(batch, tile=tile,
                                           n_blocks=n_blocks, stage=stage)
                    got = launcher(sk._library_launch, flat, x, th, mask)
                    torch.cuda.synchronize()
                    if first is None:
                        first = got
                    # sums of up to 65,536 rows in another order: relative
                    require_close(got, first, f"step_grads batch {batch} "
                                  f"tile {tile} blocks {n_blocks} staged "
                                  f"{stage}", 1e-4, 1e-4)
                    by_tiling[f"{tile}x{n_blocks}{'s' if stage else ''}"] = [
                        host_split_ms(lambda: launcher(
                            sk._library_launch, flat, x, th, mask, denom=den,
                            out=buf, phases=ph), reps=30)[1]
                        for ph in (3, 1, 2)]
                    sp._launchers.clear()     # partial buffers: one at a time
        tile, blocks, staged = sp.launch_shape(batch)
        out[str(batch)] = dict(
            ms_all_tiles_reduction_by_tile_x_blocks=by_tiling,
            default=f"{tile}x{blocks}{'s' if staged else ''}")
    return out


def step_kernel_row(flows, launches, err_small, device, card):
    """The {"kernels": ...} entry of step_grads: held against its plain
    version and timed at the streaming path's shape (batch 1024 of the d 16 /
    hidden 64 chain) and at the README / BASELINE shape (batch 64)."""
    rng = np.random.default_rng(SEED + 9)
    out = {}
    for name, flow, batch in (("med", flows["med"], MED["batch"]),
                              ("baseline", flows["stream50k"], TRAIN_BATCH)):
        d, n = flow.metadata.d, flow.metadata.n
        folded = ft.fold_for_step(flow)
        sp = folded.step_plan
        flat = sp.flatten(folded.tparams)
        x, th = data(rng, batch, d, n, device)
        mask = torch.ones(batch, device=device)
        got = sp.loss_and_grads(flat, x, th, mask)
        want = plain_packed(sp, folded.tparams, x, th, mask)
        err = require_step_close(got, want, f"step_grads at the {name} shape")
        # the denominator contract: two shards with the GLOBAL denominator
        # sum to the whole batch in one launch
        half = batch // 2
        denom = mask.sum()
        parts = [sp.loss_and_grads(flat, x[s], th[s], mask[s], denom=denom)
                 for s in (slice(0, half), slice(half, batch))]
        shard_err = require_close(parts[0] + parts[1], got,
                                  f"step_grads {name}: shards with the "
                                  "global denominator", 1e-5, 1e-5)
        own = [sp.loss_and_grads(flat, x[s], th[s], mask[s])
               for s in (slice(0, half), slice(half, batch))]
        torch.cuda.synchronize()
        # with each shard's own denominator the sum is the batch's doubled
        if abs(float(own[0][-1] + own[1][-1]) - 2 * float(got[-1])) > 1e-3:
            fail(f"step_grads {name}: shard losses with their own "
                 "denominators should sum to twice the batch's")
        again = sp.loss_and_grads(flat, x, th, mask)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"step_grads at the {name} shape: two launches differ")
        ms = time_ms(lambda: sp.loss_and_grads(flat, x, th, mask), runs=25)
        plain = time_ms(lambda: plain_packed(sp, folded.tparams, x, th,
                                             mask), runs=7)
        # the call apart: host enqueue, the device's pace back to back, each
        # kernel's device time (profiler), each kernel alone (events)
        den = mask.sum().reshape(1)
        buf = torch.empty(sp.n_params + 1, device=device)
        launcher = sp.launcher(batch)
        host_ms, b2b_ms = host_split_ms(
            lambda: sp.loss_and_grads(flat, x, th, mask, denom=den))
        by_kernel = device_ms_by_kernel(
            lambda: sp.loss_and_grads(flat, x, th, mask, denom=den))
        alone = {ph: host_split_ms(lambda: launcher(
            sk._library_launch, flat, x, th, mask, denom=den, out=buf,
            phases=ph), reps=100)[1] for ph in (1, 2)}
        fwd = needed_flops_per_row(flow.model)
        flops = 3 * batch * fwd
        pk = sp.packed(launcher.tile)
        nbytes = 4 * (batch * (d + n + 1) + 1 + 2 * sp.n_params
                      + pk.flat_consts.numel() + pk.prog.numel()
                      + sp.n_params + 1)
        b_ms, by = bound_ms(flops, nbytes)
        out[name] = dict(batch=batch, ms=ms, plain_ms=plain, bound_ms=b_ms,
                         bound_by=by, max_abs_err=err,
                         shard_sum_max_abs_err=shard_err, needed_flops=flops,
                         needed_bytes=nbytes, folded_parameters=sp.n_params,
                         tile_rows=launcher.tile, blocks=launcher.n_blocks,
                         shared_bytes=launcher.shared_bytes,
                         parameters_in_shared_memory=launcher.staged,
                         host_enqueue_ms=host_ms, back_to_back_ms=b2b_ms,
                         device_ms_by_kernel=by_kernel,
                         tile_kernel_back_to_back_ms=alone[1],
                         reduction_back_to_back_ms=alone[2])
    say(phase="step_kernel_times", card=card, **out)
    for name, flow, batches in (
            ("med", flows["med"], (MED["batch"], 8192, 65536)),
            ("baseline", flows["stream50k"], (TRAIN_BATCH, 1024, 8192))):
        folded = ft.fold_for_step(flow)
        sp = folded.step_plan
        say(phase="step_tile_sweep", card=card, config=name,
            **step_tile_sweep(sp, sp.flatten(folded.tparams),
                              flow.metadata.d, flow.metadata.n, batches,
                              device))
    med, base = out["med"], out["baseline"]
    return {
        "name": "step_grads", "route": "cuda",
        "source": "densityflows_tpu_torch/csrc/step_kernels.cu",
        "replaces": "densityflows_tpu/ops/pallas_step.py:48",
        "launches": launches["med"],
        "launches_stream50k": launches["stream50k"],
        "launches_mesh": launches["mesh"],
        "max_abs_err": max(err_small, med["max_abs_err"],
                           base["max_abs_err"]),
        "max_abs_err_small_cases": err_small, "tolerance": STEP_TOL,
        "shape": f"one batch of {med['batch']} rows, d {MED['d']}, theta "
                 f"{MED['n']}, 3 split couplings hidden {MED['hidden']} + "
                 f"affine ({med['folded_parameters']} folded parameters), "
                 f"{med['blocks']} blocks of {med['tile_rows']} rows",
        "ms": med["ms"], "plain_ms": med["plain_ms"],
        "bound_ms": med["bound_ms"], "bound_by": med["bound_by"],
        "library_ms": None, "needed_flops": med["needed_flops"],
        "needed_bytes": med["needed_bytes"],
        "ms_batch64": base["ms"], "plain_ms_batch64": base["plain_ms"],
        "bound_ms_batch64": base["bound_ms"],
        "bound_by_batch64": base["bound_by"],
        "device_ms_by_kernel": med["device_ms_by_kernel"],
        "device_ms_by_kernel_batch64": base["device_ms_by_kernel"],
        "host_enqueue_ms": med["host_enqueue_ms"],
        "host_enqueue_ms_batch64": base["host_enqueue_ms"],
        "parameters_in_shared_memory": med["parameters_in_shared_memory"],
        "parameters_in_shared_memory_batch64":
            base["parameters_in_shared_memory"],
        "shard_sum_max_abs_err": max(med["shard_sum_max_abs_err"],
                                     base["shard_sum_max_abs_err"]),
    }


# -- the streaming whole-run trainer: the main path of train_stream -----------------

def reset_counts():
    ck.reset_launch_counts()
    cpk.reset_launch_counts()
    tk.run_fused_train.launches = 0
    sk.run_fused_grads.launches = 0
    stk.run_fused_train_stream.launches = 0


def read_counts():
    return dict(ck.launch_counts(), train_run=tk.run_fused_train.launches,
                step_grads=sk.run_fused_grads.launches,
                train_stream=stk.run_fused_train_stream.launches,
                **cpk.launch_counts())


def drive_train_stream(x, th, device):
    """``train(flow, data, epochs=3, batchsize=1024, generator=...)`` with
    default routing at the "med" config, on a DataArrays of the 2^20 rows of
    ``med_data`` split 0.9 / 0.1: past train_run's shared memory, so
    train_fused takes the stream mode. Checks the mode, the launch counts,
    the Adam count, a falling train NLL, the final validation NLL against
    ``flow.log_prob``, and the first 32 steps against the plain version on
    the same permutations."""
    batch, epochs = MED["batch"], MED["epochs"]
    dataset = dt.DataArrays.make(x, th, rng=0)
    n_train = len(dataset.partition.training)
    n_batches = -(-n_train // batch)

    def make():
        return med_flow(x[:256], th, device, SEED)

    flow = make()
    n_params = ft.fold_for_step(flow).step_plan.n_params
    chunks = -(-epochs // ft.stream_chunk_epochs(n_params, n_train, batch,
                                                 epochs))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a decline warns
        state = dt.train(flow, dataset, epochs=epochs, batchsize=batch,
                         verbose=False,
                         generator=torch.Generator().manual_seed(SEED + 7))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = read_counts()
    if flow.trained_path != "fused" or flow.fused_kernel_mode != "stream":
        fail(f"train took {flow.trained_path} / {flow.fused_kernel_mode} "
             f"({flow.fused_decline_reason}), expected the stream mode")
    if launches != dict(chain_apply=0, chain_sample=0, train_run=0,
                        step_grads=0, train_stream=chunks, coupling_fwd=0,
                        coupling_bwd=0, coupling_bwd_reduce=0):
        fail(f"train_stream main path launches {launches}, expected "
             f"{chunks} train_stream launch(es) and no other kernel")
    if state.count != epochs * n_batches:
        fail(f"train_stream main path: Adam count {state.count}, expected "
             f"{epochs} x {n_batches}")
    tl, vl = np.asarray(flow.train_loss), np.asarray(flow.valid_loss)
    if tl.shape != (epochs,) or vl.shape != (epochs,) or \
            not (np.isfinite(tl).all() and np.isfinite(vl).all()):
        fail(f"train_stream main path: histories {tl} / {vl}")
    if not bool((np.diff(tl) < 0).all()):
        fail(f"train_stream main path: train NLL does not fall: {tl}")
    xv, thv = dataset.validation_data()
    with torch.no_grad():
        lp = flow.log_prob(put(xv, device), put(thv, device))
    nll = float(-lp.mean())
    if abs(nll - vl[-1]) > 1e-4:
        fail(f"train_stream main path: final validation NLL {vl[-1]} != "
             f"-mean log_prob {nll}")

    # the first 32 steps: the kernel and its plain version on the batches
    # the run began with (the permutations train drew from that generator)
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED + 7),
                                epochs, n_train)
    start = make()
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(start.model)
    xt, tht = dataset.normalized_training_data(start.metadata)
    first = perms[0, :min(32, n_train // batch) * batch]
    x32, th32 = put(xt[first], device), put(tht[first], device)
    order = np.arange(len(first))[None]
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros)
    runs = {}
    for steps in (1, len(first) // batch):
        rows = slice(0, steps * batch)
        args = head + (x32[rows], th32[rows], order[:, rows])
        runs[steps] = (
            stk.run_fused_train_stream(*args, batchsize=batch,
                                       with_losses=True),
            stk.fused_train_stream_plain(*args, batchsize=batch,
                                         with_losses=True))
    torch.cuda.synchronize()
    got, want = runs[len(first) // batch]
    loss_err = require_close(got[5], want[5],
                             "first 32 steps: losses vs the plain version",
                             **TRAIN_TOL)
    # One step differs by rounding only. Over 32 steps Adam amplifies that
    # rounding where an entry's gradient is small against its history: on
    # this batch order the kernel — whose per-step gradient equals
    # step_grads' bit for bit and whose Adam is within an ulp of the plain
    # one — and step_grads + Adam alike end 4.5e-4 from the plain version
    # on one entry. The gate is the streaming trainer's for its first 32
    # steps (parameters 1e-3), and the first step's parameters are held to
    # 1e-5.
    first_err = max(require_close(a, b, f"first step: param {k}", 0.0, 1e-5)
                    for k, (a, b) in enumerate(zip(*(r[0] for r in
                                                     runs[1]))))
    param_err = max(require_close(a, b, f"first 32 steps: param {k}", 0.0,
                                  1e-3)
                    for k, (a, b) in enumerate(zip(got[0], want[0])))
    steps = epochs * n_batches
    report = dict(
        rows=int(x.shape[0]), n_train=n_train, batchsize=batch, epochs=epochs,
        steps=steps, chunks=chunks, seconds=seconds,
        ms_per_step=1e3 * seconds / steps,
        rows_per_s=epochs * n_train / seconds, train_nll=tl.tolist(),
        valid_nll=vl.tolist(), valid_nll_vs_log_prob=abs(nll - float(vl[-1])),
        first_step_param_err=first_err, first_32_steps_loss_err=loss_err,
        first_32_steps_param_err=param_err)
    return launches["train_stream"], report, (make, dataset, perms)


def stream_kernel_row(make, dataset, perms, launches, err_small, err_main,
                      err_params_32, card):
    """The {"kernels": ...} entry of train_stream at the main path's shapes:
    one epoch (the main path's first permutation) of the kernel and of its
    plain version from the main path's starting weights; the per-epoch
    evaluation of the snapshots alone."""
    batch = MED["batch"]
    flow = make()
    device = flow.device
    folded = ft.fold_for_step(flow)
    sp = folded.step_plan
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(flow.model)
    xt, tht = dataset.normalized_training_data(flow.metadata)
    xv, thv = dataset.normalized_validation_data(flow.metadata)
    xt, tht, xv, thv = (put(a, device) for a in (xt, tht, xv, thv))
    n_train, d = xt.shape
    n_cond = tht.shape[1]
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, xt, tht,
            perms[:1])

    def kernel():
        return stk.run_fused_train_stream(*head, batchsize=batch,
                                          step_plan=sp, with_losses=True)

    got = kernel()
    torch.cuda.synchronize()
    ms = time_ms(kernel, warmup=1, runs=3)
    t0 = time.time()
    want = stk.fused_train_stream_plain(*head, batchsize=batch,
                                        with_losses=True)
    torch.cuda.synchronize()
    plain = 1e3 * (time.time() - t0)
    # over a whole epoch (922 Adam steps) the two trajectories drift by
    # rounding: reported here, gated over the first 32 steps above
    drift = {name: max(float((a - b).abs().max())
                       for a, b in zip(got[i], want[i]))
             for i, name in ((0, "params"), (1, "mu"), (2, "nu"))}
    drift["losses"] = float((got[5] - want[5]).abs().max())

    snaps = stk.run_fused_train_stream(*head[:9], perms, batchsize=batch,
                                       step_plan=sp)[3]
    eval_ms = time_ms(lambda: [stk.eval_snapshots(
        snaps, cparams, xs, ths, None, plan=plan,
        row_chunk=ft._EVAL_ROW_CHUNK) for xs, ths in ((xt, tht), (xv, thv))],
        warmup=1, runs=3)

    tile, threads, shared, n_blocks, staged = stk.device_launch_shape(
        sp, batch)
    co_resident = stk.co_resident_blocks(threads, shared)
    n_batches = -(-n_train // batch)
    n_pad = n_batches * batch
    # the bound: the products the epoch needs (forward + two backward per
    # layer and training row) over the f32 rate, against every input read
    # once and every output written once — rows, order, parameters and both
    # moments in and out, the masks, constants and program, one snapshot
    flops = 3 * n_train * needed_flops_per_row(flow.model)
    pk = sp.packed(tile)
    nbytes = 4 * (n_train * (d + n_cond) + n_pad + 7 * sp.n_params
                  + pk.flat_consts.numel() + pk.prog.numel() + 1)
    b_ms, by = bound_ms(flops, nbytes)
    say(phase="stream_kernel_times", card=card, epoch_steps=n_batches,
        train_stream_ms_per_epoch=ms, train_stream_ms_per_step=ms / n_batches,
        plain_version_ms_per_epoch=plain,
        plain_version_ms_per_step=plain / n_batches,
        eval_snapshots_ms_3_epochs_both_splits=eval_ms,
        tile_rows=tile, threads=threads, shared_bytes=shared, blocks=n_blocks,
        parameters_staged=staged,
        co_resident_blocks=co_resident, folded_parameters=sp.n_params,
        drift_one_epoch_vs_plain=drift)
    return {
        "name": "train_stream", "route": "cuda",
        "source": "densityflows_tpu_torch/csrc/stream_kernels.cu",
        "replaces": "densityflows_tpu/ops/pallas_train_stream.py:58",
        "launches": launches, "max_abs_err": max(err_small, err_main),
        "max_abs_err_small_cases": err_small,
        "max_abs_err_main_path_first_step_and_32_losses": err_main,
        "tolerance": TRAIN_TOL,
        "max_abs_err_main_path_32_steps_parameters": err_params_32,
        "tolerance_32_steps_parameters": dict(rtol=0.0, atol=1e-3),
        "shape": f"one epoch of {n_batches} batches of {batch} over "
                 f"{n_train} rows, d {d}, theta {n_cond}, 3 split couplings "
                 f"hidden {MED['hidden']} + affine ({sp.n_params} folded "
                 f"parameters), {n_blocks} blocks of {tile} rows x {threads} "
                 f"threads",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "ms_per_step": ms / n_batches,
        "plain_ms_per_step": plain / n_batches, "eval_snapshots_ms": eval_ms,
        "needed_flops": flops, "needed_bytes": nbytes,
    }


# -- the per-layer coupling kernels: coupling_fwd / coupling_bwd ---------------------

# the opt-in per-layer train step at the wide config (benchmarks/wide_config.py
# "fused_f32"): batch 8192 from a pool of 2^16 rows, Adam 1e-3
COUPLING = dict(batch=8192, pool=1 << 16, steps=32, epochs=2)
# the short-run rule of the streaming trainer: losses, then parameters. At
# the wide config two plain f32 versions of the same step (autograd and the
# hand-written pullback) already end 32 Adam steps further apart than 1e-3 on
# entries whose gradient is small against their history, so the parameters
# are held to FLOOR_FACTOR times that measured floor where it exceeds 1e-3;
# every step's gradients are held to KERNEL_TOL on the same weights.
SHORT_RUN_TOL = (1e-4, 1e-3)
FLOOR_FACTOR = 3.0


def coupling_nets(rng, kind, K, A, hidden, n_s, n_t, act, bias, device):
    """``(weights, biases, activation)`` nets for the wrappers, glorot-uniform
    numpy draws with the final layer scaled by 0.3 (so s and t are not 0);
    ``n_s`` / ``n_t`` hidden layers (0: one dense layer)."""
    def net(n_sub):
        dims = [K] + [hidden] * n_sub + [A]
        ws, bs = [], []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lim = np.sqrt(6.0 / (a + b)) * (0.3 if i == len(dims) - 2 else 1)
            ws.append(put(rng.uniform(-lim, lim, size=(a, b)), device))
            if bias:
                bs.append(put(rng.normal(size=b) * 0.05, device))
        return ws, bs, act

    return (net(n_s) if kind == "nvp" else None), net(n_t)


def flat_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out if o is not None for x in flat_tensors(o)]


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def require_close_nan(got, want, what):
    """KERNEL_TOL where the plain version is finite; NaN where it is NaN and
    the same infinity where it is +-inf."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail(f"{what}: NaN pattern differs from the plain version")
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf])):
        fail(f"{what}: +-inf pattern differs from the plain version")
    ok = torch.isfinite(want)
    if not bool(ok.any()):
        return 0.0
    return require_close(got[ok], want[ok], what, **KERNEL_TOL)


def check_coupling_case(rng, device, name, rows, K=6, A=4, hidden=18, n_s=2,
                        n_t=2, act="relu", bias=True, kinds=("nvp", "nice"),
                        nan_row=False):
    """Both kernels against their plain versions, both directions, the
    forward with and without ldj, the backward with a non-zero g_ldj and
    twice (the same bits). K 6 / A 4 / hidden 18 is d 7, n 3, h 18."""
    worst = 0.0
    for kind in kinds:
        s, t = coupling_nets(rng, kind, K, A, hidden, n_s, n_t, act, bias,
                             device)
        h = rng.normal(size=(rows, K))
        if nan_row:
            h[min(3, rows - 1), 1] = np.nan
        h, y, gy = (put(a, device) for a in
                    (h, rng.normal(size=(rows, A)), rng.normal(size=(rows, A))))
        gl = put(rng.normal(size=rows), device)
        for direction in ("forward", "inverse"):
            tag = f"coupling {name} {kind} {direction}"
            for with_ldj in (True, False):
                got = cpk.coupling_fwd(s, t, h, y, direction=direction,
                                       with_ldj=with_ldj)
                torch.cuda.synchronize()
                want = cpk.coupling_fwd_plain(s, t, h, y, direction=direction,
                                              with_ldj=with_ldj)
                for i, (a, b) in enumerate(zip(flat_tensors(got),
                                               flat_tensors(want))):
                    worst = max(worst, require_close_nan(
                        a, b, f"{tag} coupling_fwd ldj={with_ldj} out {i}"))
            got = flat_tensors(cpk.coupling_bwd(s, t, h, y, gy, gl,
                                                direction=direction))
            again = flat_tensors(cpk.coupling_bwd(s, t, h, y, gy, gl,
                                                  direction=direction))
            torch.cuda.synchronize()
            want = flat_tensors(cpk.coupling_bwd_plain(
                s, t, h, y, gy, gl, direction=direction))
            if len(got) != len(want):
                fail(f"{tag}: coupling_bwd gave {len(got)} tensors, the plain "
                     f"version {len(want)}")
            # dh, dy, then every dW / db
            for i, (a, b) in enumerate(zip(got, want)):
                worst = max(worst, require_close_nan(
                    a, b, f"{tag} coupling_bwd output {i}"))
            if not all(bits_equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: two coupling_bwd launches differ")
    return worst


def check_coupling_small(device):
    rng = np.random.default_rng(SEED + 5)
    errs = {
        "d7_n3_h18_rows_1001": check_coupling_case(rng, device, "d7", 1001),
        "rows_37": check_coupling_case(rng, device, "rows 37", 37,
                                       act="tanh"),
        "rows_5_below_one_tile": check_coupling_case(rng, device, "rows 5", 5),
        "n_s_1_n_t_3": check_coupling_case(rng, device, "n_s 1 n_t 3", 300,
                                           n_s=1, n_t=3, kinds=("nvp",)),
        "one_dense_layer": check_coupling_case(rng, device, "one layer", 300,
                                               n_s=0, n_t=0),
        "no_bias": check_coupling_case(rng, device, "no bias", 300,
                                       bias=False, act="elu"),
        "nan_row": check_coupling_case(rng, device, "NaN row", 64,
                                       nan_row=True),
        "main_shape": check_coupling_case(
            rng, device, "K24 A16 H256", COUPLING["batch"], K=24, A=16,
            hidden=256, kinds=("nvp",)),
    }
    for act in ACTIVATIONS:
        errs[f"act_{act}"] = check_coupling_case(
            rng, device, f"act {act}", 257, act=act, kinds=("nvp",))
    return errs


def coupling_pool(device):
    """The main path's rows, as benchmarks/wide_config.py draws them: x
    normal, theta uniform in [0, 1), from numpy seed SEED."""
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(COUPLING["pool"], D)).astype(np.float32)
    th = rng.uniform(0, 1, size=(COUPLING["pool"], N_COND)).astype(np.float32)
    b = COUPLING["batch"]
    batches = [(put(x[i:i + b], device), put(th[i:i + b], device))
               for i in range(0, len(x), b)]
    return x, th, batches


def coupling_steps(start, batches, mode, steps):
    """``steps`` steps of make_train_step(adam(1e-3)) from a copy of
    ``start`` under ``set_fused_kernels(mode)``: (model, losses, seconds)."""
    model = copy.deepcopy(start)
    opt = dt.adam(1e-3)
    step = dt.make_train_step(opt)
    state = opt.init(ft.trainable_leaves(model))
    base = dt.StandardNormal(D)
    mask = torch.ones(COUPLING["batch"], device=batches[0][0].device)
    losses = []
    dt.set_fused_kernels(mode)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        for k in range(steps):
            xb, thb = batches[k % len(batches)]
            model, state, loss = step(model, state, base, xb, thb, mask)
            losses.append(loss)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        dt.set_fused_kernels("auto")
    return model, torch.stack(losses), seconds


@contextlib.contextmanager
def plain_coupling_ops():
    """The per-layer route with the kernels' plain versions on the card,
    for the rounding floor of the 32-step comparison (a harness of this
    script; the package never swaps them)."""
    real = cpk.coupling_fwd, cpk.coupling_bwd
    cpk.coupling_fwd, cpk.coupling_bwd = (cpk.coupling_fwd_plain,
                                          cpk.coupling_bwd_plain)
    try:
        yield
    finally:
        cpk.coupling_fwd, cpk.coupling_bwd = real


def coupling_grads_each_step(start, batches, steps):
    """The kernels' trajectory replayed: at every step the loss and every
    gradient with the kernels against the plain autograd step on the SAME
    weights (KERNEL_TOL), then the kernels' Adam update. Returns the error
    of each step."""
    model = copy.deepcopy(start)
    opt = dt.adam(1e-3)
    state = opt.init(ft.trainable_leaves(model))
    base = dt.StandardNormal(D)
    mask = torch.ones(COUPLING["batch"], device=batches[0][0].device)
    errs = []
    for k in range(steps):
        xb, thb = batches[k % len(batches)]
        got = {}
        for mode in (True, False):
            dt.set_fused_kernels(mode)
            try:
                got[mode] = _loss_and_grads(model, base, xb, thb, mask)
            finally:
                dt.set_fused_kernels("auto")
        pairs = zip([got[True][0]] + got[True][2],
                    [got[False][0]] + got[False][2])
        errs.append(max(require_close(
            a, b, f"coupling main path step {k + 1} "
            f"{'loss' if i == 0 else f'gradient {i}'} on the same weights",
            **KERNEL_TOL) for i, (a, b) in enumerate(pairs)))
        updates, state = opt.update(got[True][2], state, got[True][1])
        with torch.no_grad():
            for p, u in zip(got[True][1], updates):
                p.add_(u)
    return errs


def coupling_counts(fwd, bwd, per_bwd=0):
    """Launch counts of ``fwd`` coupling_fwd calls and ``bwd`` coupling_bwd
    calls of ``per_bwd`` launches each (``cpk.bwd_launches``: a product
    launch per layer of the forward and of the backward, and the pullback)
    plus one reduction each."""
    return dict(chain_apply=0, chain_sample=0, train_run=0, step_grads=0,
                train_stream=0, coupling_fwd=fwd, coupling_bwd=bwd * per_bwd,
                coupling_bwd_reduce=bwd)


def layer_nets(layer):
    """A coupling layer's nets as the wrappers take them."""
    def net(m):
        return ([w.detach() for w in m.weights],
                [b.detach() for b in m.biases], m.activation)

    return net(layer.s_net), net(layer.t_net)


def declined_chain(device):
    """A small chain the chain kernel declines (a coupling whose nets are
    one dense layer each): under True, log_prob and sample reach
    coupling_fwd with ldj (``_chain_eval``) and without (``forward_``)."""
    rng = np.random.default_rng(SEED + 9)
    d, n = 7, 3
    axes = dt.coupling_axes(d, [0, 1, 2], n=n)
    K, A = axes.nn_input_dim, axes.transform_dim
    one = lambda: dt.MLP([torch.zeros(K, A, device=device)],  # noqa: E731
                         [torch.zeros(A, device=device)], "tanh")
    x_ref = rng.normal(size=(64, d)).astype(np.float32)
    chain = numpy_weights_(dt.flow_chain(
        dt.RNVPCouplingLayer(one(), one(), axes),
        dt.coupling_layer(d, [3, 4, 5, 6], n=n, kind=dt.NICECouplingLayer,
                          hidden_dim_t=32, device=device),
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device)), rng, 0.3)
    if fc.chain_is_fusable(chain, d, n):
        fail("declined chain: the chain kernel would take it")
    flow = dt.Flow(chain, dt.MetaData("", d, n, np.zeros(n), np.ones(n)),
                   device=device)
    x, th = data(rng, 3000, d, n, device)
    out = {}
    for mode in (True, False):
        dt.set_fused_kernels(mode)
        try:
            reset_counts()
            with torch.no_grad():
                lp = flow.log_prob(x, th)
                smp = flow.sample((3000,), (0.5,) * n,
                                  generator=torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            out[mode] = (lp, smp, read_counts())
        finally:
            dt.set_fused_kernels("auto")
    # two couplings: log_prob (with ldj) and sample (forward_, without)
    if out[True][2] != coupling_counts(4, 0):
        fail(f"declined chain under True: launches {out[True][2]}")
    if out[False][2] != coupling_counts(0, 0):
        fail(f"declined chain under False: launches {out[False][2]}")
    return max(require_close(out[True][0], out[False][0],
                             "declined chain: log_prob", **KERNEL_TOL),
               require_close(out[True][1], out[False][1],
                             "declined chain: sample", **KERNEL_TOL))


def drive_coupling_main_path(device):
    """The opt-in per-layer train step at the wide config: the wide split
    chain (d 32, n 8, 4 coupling blocks of hidden 256, normalization; its
    non-zero final weights keep s != 0) on batches of 8192 from 2^16 rows.
    32 steps of make_train_step under True (launches asserted) against the
    same 32 under False and against the rounding floor; every step's loss and
    gradients against the plain autograd step on the same weights; then
    ``train(..., fused_kernel=False)`` on a DataArrays of the rows under True
    and the declined chain."""
    steps, batch = COUPLING["steps"], COUPLING["batch"]
    x, th, batches = coupling_pool(device)
    start = wide_chain(False, np.random.default_rng(SEED + 11), device)
    n_couplings = sum(isinstance(layer, dt.RNVPCouplingLayer)
                      for layer in fc._iter_layers(start, "fwd"))
    per_bwd = cpk.bwd_launches(*layer_nets(next(fc._iter_layers(start,
                                                                "fwd"))))
    reset_counts()
    model_k, losses_k, sec_k = coupling_steps(start, batches, True, steps)
    launches = read_counts()
    per_step = n_couplings
    if launches != coupling_counts(per_step * steps, per_step * steps,
                                   per_bwd):
        fail(f"coupling main path launches {launches}, expected "
             f"{per_step} coupling_fwd and {per_step} coupling_bwd calls of "
             f"{per_bwd} launches (+ a reduction) per step and no other "
             "kernel")
    model_p, losses_p, sec_p = coupling_steps(start, batches, False, steps)
    with plain_coupling_ops():
        model_f, losses_f, _ = coupling_steps(start, batches, True, steps)

    def param_errs(model):
        return [float((a - b).detach().abs().max()) for a, b in zip(
            ft.trainable_leaves(model), ft.trainable_leaves(model_p))]

    floor = max(param_errs(model_f))
    param_tol = max(SHORT_RUN_TOL[1], FLOOR_FACTOR * floor)
    loss_err = require_close(losses_k, losses_p, f"{steps} steps: losses",
                             0.0, SHORT_RUN_TOL[0])
    param_err = max(require_close(a, b, f"{steps} steps: param {k}", 0.0,
                                  param_tol)
                    for k, (a, b) in enumerate(zip(
                        ft.trainable_leaves(model_k),
                        ft.trainable_leaves(model_p))))
    errs_k = param_errs(model_k)
    step_errs = coupling_grads_each_step(start, batches, steps)

    # train() as a user calls it, the plain program under True
    dataset = dt.DataArrays.make(x, th, rng=0)
    flow = dt.Flow(copy.deepcopy(start), dataset, device=device)
    n_batches = -(-len(dataset.partition.training) // batch)
    epochs = COUPLING["epochs"]
    nll0 = dt.evaluate(flow, dataset, "training")
    dt.set_fused_kernels(True)
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        dt.train(flow, dataset, epochs=epochs, batchsize=batch,
                 fused_kernel=False, verbose=False,
                 generator=torch.Generator().manual_seed(SEED + 13))
        torch.cuda.synchronize()
        train_seconds = time.time() - t0
        train_launches = read_counts()
    finally:
        dt.set_fused_kernels("auto")
    # per epoch: every batch's loss and gradient, then the two full-split
    # evaluations of the plain program (forward only)
    want = coupling_counts(epochs * (n_batches + 2) * per_step,
                           epochs * n_batches * per_step, per_bwd)
    if train_launches != want:
        fail(f"train under True: launches {train_launches}, expected {want}")
    tl, vl = np.asarray(flow.train_loss), np.asarray(flow.valid_loss)
    if flow.trained_path != "torch" or not (np.isfinite(tl).all()
                                            and np.isfinite(vl).all()):
        fail(f"train under True: path {flow.trained_path}, NLL {tl} / {vl}")
    # from the random start the NLL falls, though not in every epoch
    if not tl[-1] < nll0:
        fail(f"train under True: the NLL does not fall from {nll0}: {tl}")
    declined_err = declined_chain(device)
    report = dict(
        config=f"d {D}, n {N_COND}, {N_BLOCKS} coupling blocks hidden "
               f"{HIDDEN} + normalization, batch {batch}, pool {len(x)}",
        step1_max_abs_err=step_errs[0],
        each_step_max_abs_err_same_weights=max(step_errs), steps=steps,
        steps_loss_max_abs_err=loss_err, steps_param_max_abs_err=param_err,
        steps_param_tensors_over_1e_3=sum(e > SHORT_RUN_TOL[1]
                                              for e in errs_k),
        rounding_floor_param_err=floor,
        rounding_floor_loss_err=float((losses_f - losses_p).abs().max()),
        steps_param_tolerance=param_tol,
        steps_seconds_kernels=sec_k, steps_seconds_plain=sec_p,
        ms_per_step_kernels_first_32=1e3 * sec_k / steps,
        ms_per_step_plain_first_32=1e3 * sec_p / steps,
        train_epochs=epochs, train_batches_per_epoch=n_batches,
        train_seconds=train_seconds, train_nll_before=nll0,
        train_nll=tl.tolist(),
        valid_nll=vl.tolist(), train_launches=train_launches,
        coupling_bwd_launches_per_call=per_bwd,
        declined_chain_max_abs_err=declined_err)
    return launches, report, (start, batches)


def coupling_kernel_rows(start, batches, launches, errs, card):
    """The {"kernels": ...} entries of coupling_fwd / coupling_bwd at the main
    path's shapes: the first coupling of the wide chain on one batch (8192
    rows, K 24, A 16, hidden 256) in the inverse direction the loss runs.
    Also the backward's kernels apart, and the per-layer train step against
    the plain autograd step on the same weights."""
    device = batches[0][0].device
    layer = next(fc._iter_layers(start, "fwd"))
    xb, thb = batches[0]
    y_id, y_af = cpl.split_features(xb, layer.axes)
    h = cpl.nn_input(y_id, thb).contiguous()
    y = y_af.contiguous()

    s, t = layer_nets(layer)
    B, K = h.shape
    A = y.shape[1]
    rng = np.random.default_rng(SEED + 17)
    gy = put(rng.normal(size=(B, A)), device)
    gl = put(rng.normal(size=B), device)
    ms_f = time_ms(lambda: cpk.coupling_fwd(s, t, h, y, direction="inverse"),
                   runs=15)
    ms_b = time_ms(lambda: cpk.coupling_bwd(s, t, h, y, gy, gl,
                                            direction="inverse"), runs=15)
    plain_f = time_ms(lambda: cpk.coupling_fwd_plain(
        s, t, h, y, direction="inverse", with_ldj=True), runs=15)
    plain_b = time_ms(lambda: cpk.coupling_bwd_plain(
        s, t, h, y, gy, gl, direction="inverse"), runs=15)
    # the backward apart: each kernel's device time, and each launch's in
    # launch order (profiler)
    by_kernel = device_ms_by_kernel(lambda: cpk.coupling_bwd(
        s, t, h, y, gy, gl, direction="inverse"))
    by_launch = launch_ms(lambda: cpk.coupling_bwd(
        s, t, h, y, gy, gl, direction="inverse"), cpk.bwd_launches(s, t) + 1)
    host_ms, _ = host_split_ms(lambda: cpk.coupling_bwd(
        s, t, h, y, gy, gl, direction="inverse"), reps=50)
    stream = torch.cuda.current_stream().cuda_stream
    segs = cpk.bwd_segments(B)

    def part(n_segs, workspace):
        return lambda: cpk._run_bwd(
            lambda *a: cpk._library().df_coupling_bwd(*a, stream), s, t, h, y,
            gy, gl, direction="inverse", workspace=workspace, segs=n_segs)

    # the forward at the row tiles it can take (the default: 8); the
    # backward at other row segment counts of its dW products
    need = {"fwd": lambda r: cpk.fwd_shared_bytes(r, s, t, K, A)}
    by_tile = {}
    for tb in (8, 16, 32, 64):
        cpk.set_tile_rows(tb)
        try:
            by_tile[tb] = dict(
                tile_taken=cpk.pick_tile("fwd", need["fwd"]),
                fwd=time_ms(lambda: cpk.coupling_fwd(
                    s, t, h, y, direction="inverse"), runs=7))
        finally:
            cpk.set_tile_rows(None)
    by_segs = {}
    for n_segs in (4, 8, 16, 32):
        w_s = torch.empty(cpk.workspace_floats(B, s, t, n_segs),
                          device=device)
        by_segs[n_segs] = time_ms(part(n_segs, w_s), runs=7)
        del w_s

    base = dt.StandardNormal(D)
    mask = torch.ones(B, device=device)
    step_ms = {}
    for mode in (True, False):
        model = copy.deepcopy(start)
        opt = dt.adam(1e-3)
        step = dt.make_train_step(opt)
        state = opt.init(ft.trainable_leaves(model))
        dt.set_fused_kernels(mode)
        try:
            step_ms[mode] = time_ms(lambda: step(model, state, base, xb, thb,
                                                 mask))
        finally:
            dt.set_fused_kernels("auto")

    # the bounds: 2.K.N of every product at the nets' own shapes over the
    # f32 rate (the backward: the forward again, dX and dW, three times the
    # forward's), against each input read once and each output written once
    mats = sum(int(w.shape[0] * w.shape[1]) for n_ in (s, t) for w in n_[0])
    n_par = sum(int(p.numel()) for n_ in (s, t) for p in n_[0] + n_[1])
    flops_f = 2 * B * mats
    bytes_f = 4 * (B * (K + A) + n_par + B * A + B)
    bf_ms, bf_by = bound_ms(flops_f, bytes_f)
    bytes_b = 4 * (B * (K + 2 * A + 1) + n_par + B * (K + A) + n_par)
    bb_ms, bb_by = bound_ms(3 * flops_f, bytes_b)
    n_c = sum(isinstance(c, dt.RNVPCouplingLayer)
              for c in fc._iter_layers(start, "fwd"))
    tiles = {"fwd": cpk.pick_tile("fwd", need["fwd"])}
    say(phase="coupling_times", card=card, rows=B, K=K, A=A, hidden=HIDDEN,
        coupling_fwd_ms=ms_f, coupling_bwd_ms=ms_b,
        coupling_bwd_device_ms_by_kernel=by_kernel,
        coupling_bwd_device_ms_by_launch=by_launch,
        coupling_bwd_host_enqueue_ms=host_ms, coupling_bwd_segments=segs,
        coupling_bwd_ms_by_segments=by_segs,
        coupling_bwd_launches_per_call=cpk.bwd_launches(s, t),
        coupling_fwd_plain_ms=plain_f,
        coupling_bwd_plain_ms=plain_b, coupling_fwd_bound_ms=bf_ms,
        coupling_bwd_bound_ms=bb_ms, step_ms_per_layer_kernels=step_ms[True],
        step_ms_plain_autograd=step_ms[False],
        step_kernel_bound_ms=n_c * (bf_ms + bb_ms), tile_rows=tiles,
        ms_by_tile_rows=by_tile,
        workspace_bytes=4 * cpk.workspace_floats(B, s, t, segs))
    shape = (f"one coupling, inverse, h ({B}, {K}), y ({B}, {A}), two nets "
             f"{K}->{HIDDEN}->{HIDDEN}->{A}")
    common = dict(route="cuda",
                  source="densityflows_tpu_torch/csrc/coupling_kernels.cu",
                  tolerance=KERNEL_TOL, shape=shape, library_ms=None,
                  library_note="no single PyTorch call computes an MLP pair "
                               "plus the coupling and its ldj")
    return [
        dict(name="coupling_fwd",
             replaces="densityflows_tpu/ops/pallas_coupling.py:226",
             launches=launches["coupling_fwd"], max_abs_err=errs["fwd"],
             ms=ms_f, plain_ms=plain_f, bound_ms=bf_ms, bound_by=bf_by,
             needed_flops=flops_f, needed_bytes=bytes_f,
             tile_rows=tiles["fwd"], **common),
        dict(name="coupling_bwd",
             replaces="densityflows_tpu/ops/pallas_coupling.py:263",
             launches=launches["coupling_bwd"], max_abs_err=errs["bwd"],
             ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms, bound_by=bb_by,
             needed_flops=3 * flops_f, needed_bytes=bytes_b,
             device_ms_by_kernel=by_kernel, device_ms_by_launch=by_launch,
             host_enqueue_ms=host_ms,
             launches_per_call=cpk.bwd_launches(s, t),
             reduce_launches=launches["coupling_bwd_reduce"],
             row_segments=segs, **common),
    ]


# -- phase 5: times and bounds ---------------------------------------------------

def needed_flops_per_row(chain):
    """2·K·N of every product the function needs, from the layers' own
    shapes: per conditioner (n + identity dims)·H, H·H per hidden layer and
    H·(transformed dims), plus d·d per invertible-linear layer. The zero
    rows and columns that folding adds to a net's first and last matrix are
    work the kernel does, not work the function needs; the elementwise work
    is left out."""
    flops = 0
    for layer in fc._iter_layers(chain, "fwd"):
        for net in fc._conditioner_nets(layer):
            flops += sum(2 * w.shape[0] * w.shape[1] for w in net.weights)
        if isinstance(layer, dt.InvertibleLinearLayer):
            flops += 2 * layer.d * layer.d
    return flops


def state_bytes(chain):
    return 4 * sum(t.numel() for t in
                   list(chain.parameters()) + list(chain.buffers()))


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    """The least time for ``flops`` at ``peak_flops`` and ``nbytes`` at the
    memory rate, and which of the two bounds it."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_rows(flow, x, theta, errs, launches):
    """The {"kernels": [...]} entries: both kernels at the main path's
    shapes (wide split flow, 2^18 rows)."""
    chain = flow.model
    th = flow.prepare_theta(theta, (ROWS,)).contiguous()
    th1 = th[:1].contiguous()
    rows = []

    plan, params = fc._plan_params(chain, "inv")
    packed = ck.pack_plan(plan, params, D, N_COND)
    ms = time_ms(lambda: ck.run_chain(plan, params, x, th, with_ldj=True,
                                      packed=packed))
    plain = time_ms(lambda: ck.chain_apply_plain(plan, params, x, th,
                                                 with_ldj=True), runs=5)
    by_tile = {tb: time_ms(lambda: ck.run_chain(
        plan, params, x, th, with_ldj=True, packed=packed, tile_rows=tb))
        for tb in ck.TILE_ROWS}
    say(phase="tile_times", kernel="chain_apply", rows=ROWS,
        ms_by_tile_rows=by_tile,
        default_tile_rows=ck.pick_tile_rows(D, N_COND, packed.ldh))
    pbytes = state_bytes(chain)
    flops_per_row = needed_flops_per_row(chain)
    # 3xTF32: three tensor-core products per f32 product; the f32 rate's
    # bound (what the earlier f32 FMA design was held to) beside it
    b_ms, by = bound_ms(3 * ROWS * flops_per_row,
                        4 * ROWS * (2 * D + N_COND + 1) + pbytes,
                        PEAK_TF32_FLOPS)
    f32_ms = bound_ms(ROWS * flops_per_row, 0)[0]
    rows.append({
        "name": "chain_apply", "route": "cuda",
        "source": "densityflows_tpu_torch/csrc/chain_kernels.cu",
        "replaces": "densityflows_tpu/ops/pallas_chain.py:304",
        "launches": launches["chain_apply"],
        "max_abs_err": errs["chain_apply"], "tolerance": KERNEL_TOL,
        "shape": f"inverse fold with ldj, x ({ROWS}, {D}), theta ({ROWS}, "
                 f"{N_COND}), 8 split couplings hidden {HIDDEN} + affine",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "needed_flops_per_row": flops_per_row,
        "bound_rate": "3 x products at the TF32 tensor-core rate",
        "bound_ms_f32_rate": f32_ms, "rows_per_s": ROWS / (ms * 1e-3),
    })

    plan_f, params_f = fc._plan_params(chain, "fwd")
    packed_f = ck.pack_plan(plan_f, params_f, D, N_COND)
    ms = time_ms(lambda: ck.run_chain_sample(plan_f, params_f, ROWS, D, th1,
                                             seed=7, packed=packed_f))
    gen = torch.Generator(device=x.device).manual_seed(7)
    plain = time_ms(lambda: ck.chain_sample_plain(plan_f, params_f, ROWS, D,
                                                  th1, generator=gen), runs=5)
    b_ms, by = bound_ms(3 * ROWS * flops_per_row,
                        4 * (ROWS * D + N_COND) + pbytes, PEAK_TF32_FLOPS)
    rows.append({
        "name": "chain_sample", "route": "cuda",
        "source": "densityflows_tpu_torch/csrc/chain_kernels.cu",
        "replaces": "densityflows_tpu/ops/pallas_chain.py:323",
        "launches": launches["chain_sample"],
        "max_abs_err": errs["chain_sample"], "tolerance": KERNEL_TOL,
        "shape": f"in-kernel N(0,I) draw + forward fold, out ({ROWS}, {D}), "
                 f"theta (1, {N_COND}) broadcast",
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None, "needed_flops_per_row": flops_per_row,
        "bound_rate": "3 x products at the TF32 tensor-core rate",
        "bound_ms_f32_rate": f32_ms, "draws_per_s": ROWS / (ms * 1e-3),
    })
    return rows


def end_to_end_times(flow, x, theta, theta_tuple, name, card):
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        lp_ms = time_ms(lambda: flow.log_prob(x, theta))
        s_ms = time_ms(lambda: flow.sample((ROWS,), theta_tuple,
                                           generator=gen))
        dt.set_fused_kernels(False)
        try:
            lp_plain = time_ms(lambda: flow.log_prob(x, theta), runs=5)
            s_plain = time_ms(lambda: flow.sample((ROWS,), theta_tuple,
                                                  generator=gen), runs=5)
        finally:
            dt.set_fused_kernels("auto")
    times = dict(log_prob_ms=lp_ms, log_prob_rows_per_s=ROWS / (lp_ms * 1e-3),
                 log_prob_per_layer_ms=lp_plain,
                 sample_ms=s_ms, sample_draws_per_s=ROWS / (s_ms * 1e-3),
                 sample_per_layer_ms=s_plain)
    say(phase="times", flow=name, rows=ROWS, card=card, **times)
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.time()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32
    card = device_line()
    say(phase="device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda)

    t0 = time.time()
    by_source = _build.load_libraries(["chain_kernels", "train_kernels",
                                       "step_kernels", "stream_kernels",
                                       "coupling_kernels"])
    summary = {"build_seconds": time.time() - t0,
               "build_seconds_by_source": by_source}
    say(phase="build", seconds=summary["build_seconds"],
        seconds_by_source=by_source, build_dir=_build.build_dir())

    rng = np.random.default_rng(SEED)

    # phase 3a: small mixed chains (ragged row count, odd widths, n = 0)
    mixed = mixed_chain(7, 3, 18, rng, device, logit=True)
    x_s, th_s = data(rng, 1001, 7, 3, device)
    err_a = check_apply(mixed, x_s, th_s, "mixed d7 n3 h18")
    uncond = mixed_chain(6, 0, 16, rng, device, logit=False)
    x_u, th_u = data(rng, 333, 6, 0, device)
    err_a = max(err_a, check_apply(uncond, x_u, th_u, "mixed d6 n0 h16"))
    err_s, _ = check_sample(mixed, 1001, 7, th_s, "mixed sample, per-row theta")
    check_sample(uncond, 333, 6, None, "mixed sample, n = 0")
    err_g = check_gradient(mixed, x_s[:256], th_s[:256])
    err_w = check_wide_hidden(np.random.default_rng(SEED + 29), device)
    say(phase="kernels_small", chain_apply_max_abs_err=err_a,
        chain_sample_max_abs_err=err_s, gradient_max_abs_err=err_g,
        hidden_300_520_max_abs_err=err_w, tolerance=KERNEL_TOL)
    err_a, err_s = max(err_a, err_w), max(err_s, err_w)
    err_nan, nan_rows = check_chain_nan(np.random.default_rng(SEED + 23),
                                        device)
    say(phase="chain_nan_rows", max_abs_err_finite_entries=err_nan,
        plain_nan_rows=nan_rows, nan_pattern="equal to the plain version's")

    # phase 3b/3c: the wide config, split and joint, 2^18 rows
    errs = {"chain_apply": err_a, "chain_sample": err_s}
    for joint in (False, True):
        chain = wide_chain(joint, rng, device)
        x_w, th_w = data(rng, ROWS, D, N_COND, device)
        e_apply = check_apply(chain, x_w, th_w, f"wide joint={joint}")
        e_sample, z = check_sample(chain, ROWS, D, th_w[:1].contiguous(),
                                   f"wide sample joint={joint}")
        errs["chain_apply"] = max(errs["chain_apply"], e_apply)
        errs["chain_sample"] = max(errs["chain_sample"], e_sample)
        say(phase="kernels_wide", joint=joint, rows=ROWS,
            chain_apply_max_abs_err=e_apply, chain_sample_max_abs_err=e_sample,
            base_draw_z=z, tolerance=KERNEL_TOL)
        summary[f"base_draw_z_joint={joint}"] = z
        del chain, x_w, th_w

    # phase 3d: train_run against its plain version, small runs
    train_errs, train_skips = check_train_small(rng, device)
    errs["train_run"] = max(train_errs.values())
    say(phase="train_kernel_small", max_abs_err_by_case=train_errs,
        skipped_updates=train_skips, tolerance=TRAIN_TOL,
        two_calls_equal_one_call="bit for bit")

    # phase 3e: step_grads against its plain version, small chains
    step_errs = check_step_small(rng, device)
    errs["step_grads"] = max(step_errs.values())
    say(phase="step_kernel_small", max_abs_err_by_case=step_errs,
        tolerance=STEP_TOL, two_launches_equal="bit for bit")

    # phase 3f: train_stream against its plain version, small runs
    stream_errs, stream_skips = check_stream_small(rng, device)
    errs["train_stream"] = max(stream_errs.values())
    say(phase="stream_kernel_small", max_abs_err_by_case=stream_errs,
        skipped_updates=stream_skips, tolerance=TRAIN_TOL,
        two_launches_equal="bit for bit",
        two_chunked_calls_equal_one_call="bit for bit")

    # phase 3g: coupling_fwd / coupling_bwd against their plain versions
    coupling_errs = check_coupling_small(device)
    say(phase="coupling_kernel_small", max_abs_err_by_case=coupling_errs,
        tolerance=KERNEL_TOL, two_launches_equal="bit for bit")

    # phase 4: the main paths; launch counts are taken around the driven
    # calls only (checks and timings come after the counts are read)
    with tempfile.TemporaryDirectory() as tmp:
        ck.reset_launch_counts()
        driven = {}
        for joint in (False, True):
            driven[joint] = drive_main_path(joint, rng, device, tmp)
        grid_launches = grid_log_prob(rng, device)
        launches = ck.launch_counts()
    # per flow: log_prob + forward + inverse, sample + sample_sweep; the grid
    # check ran the kernel path once per chunk (its per-layer reference
    # launches nothing)
    expected = {"chain_apply": 2 * 3 + grid_launches, "chain_sample": 2 * 2}
    if launches != expected:
        fail(f"main path launches {launches}, expected {expected}: the path "
             "did not go through the kernels as it should")
    say(phase="main_path_launches", **launches)
    for joint in (False, True):
        name = "joint" if joint else "split"
        flow, x, theta, theta_tuple, lp = driven[joint]
        err, zs = check_main_path(flow, x, theta, theta_tuple, lp, name)
        say(phase="main_path", flow=name, rows=ROWS,
            log_prob_max_abs_err_vs_per_layer=err,
            log_prob_median=float(lp.median()), sample_moment_z_by_seed=zs)
        summary[f"sample_moment_z_by_seed_{name}"] = zs

    # phase 4b: the training main path and the visible decline
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_report, trained = drive_training(device, tmp)
    say(phase="train_main_path", card=card, epochs=TRAIN_EPOCHS,
        batchsize=TRAIN_BATCH, train_run_launches=train_launches,
        **train_report)
    summary["train_main_path"] = train_report
    wide = wide_stream(rng, device)
    say(phase="train_wide_stream", card=card, **wide)
    summary["train_wide_stream"] = wide
    declined = elu_decline(rng, device)
    say(phase="train_decline", card=card, **declined)
    summary["train_decline"] = declined

    # phase 4c: the streaming main path at the "med" width, then the README /
    # BASELINE model from 50,000 rows; phase 4d: the data-parallel step
    step_launches, step_flows = {}, {}
    x_m, th_m, xv_m, thv_m = med_data(np.random.default_rng(SEED))
    make_med = lambda: med_flow(x_m[:256], th_m, device, SEED)  # noqa: E731
    step_launches["med"], report, step_flows["med"] = drive_streaming(
        "streaming d16 h64", make_med, x_m, th_m, xv_m, thv_m, MED, device)
    split = step_time_split(make_med, x_m, th_m, MED, report["ms_per_step"],
                            device)
    say(phase="stream_main_path", card=card, config="d16 n4 h64 b1024",
        step_grads_launches=step_launches["med"], **report)
    say(phase="stream_step_split", card=card, config="d16 n4 h64 b1024",
        **split)
    summary["stream_med"] = dict(report, split=split)

    # phase 4e: the streaming whole-run trainer, train() on the same rows
    stream_launches, report, streamed = drive_train_stream(x_m, th_m, device)
    errs["train_stream_main_path"] = max(report["first_step_param_err"],
                                         report["first_32_steps_loss_err"])
    say(phase="train_stream_main_path", card=card, config="d16 n4 h64 b1024",
        train_stream_launches=stream_launches, **report)
    summary["train_stream_main_path"] = report
    del x_m, th_m

    x_b, th_b, xv_b, thv_b = stream50k_rows(np.random.default_rng(SEED))
    data_b = dt.DataArrays.make(x_b, th_b, rng=0)
    make_b = lambda: baseline_flow(data_b, {"x": x_b}, device, SEED)  # noqa: E731
    step_launches["stream50k"], report, step_flows["stream50k"] = \
        drive_streaming("streaming BASELINE 50k", make_b, x_b, th_b,
                        xv_b, thv_b, STREAM50K, device)
    split = step_time_split(make_b, x_b, th_b, STREAM50K,
                            report["ms_per_step"], device)
    say(phase="stream_main_path", card=card, config="BASELINE 50k b64",
        step_grads_launches=step_launches["stream50k"], **report)
    say(phase="stream_step_split", card=card, config="BASELINE 50k b64",
        **split)
    summary["stream_50k"] = dict(report, split=split)

    with tempfile.TemporaryDirectory() as tmp:
        step_launches["mesh"], mesh_report = drive_mesh(device, tmp)
    say(phase="mesh_main_path", card=card,
        step_grads_launches=step_launches["mesh"], **mesh_report)
    summary["mesh"] = mesh_report

    # phase 4f: the opt-in per-layer train step at the wide config
    coupling_launches, report, coupled = drive_coupling_main_path(device)
    say(phase="coupling_main_path", card=card, launches=coupling_launches,
        **report)
    summary["coupling_main_path"] = report

    # phase 5: times
    for joint in (False, True):
        flow, x, theta, theta_tuple, _ = driven[joint]
        name = "joint" if joint else "split"
        summary[f"times_{name}"] = end_to_end_times(flow, x, theta,
                                                    theta_tuple, name, card)
    flow, x, theta, _, _ = driven[False]
    kernels = kernel_rows(flow, x, theta, errs, launches)
    kernels.append(train_kernel_row(*trained, train_launches,
                                    errs["train_run"], device, card))
    kernels.append(step_kernel_row(step_flows, step_launches,
                                   errs["step_grads"], device, card))
    kernels.append(stream_kernel_row(
        *streamed, stream_launches, errs["train_stream"],
        errs["train_stream_main_path"],
        summary["train_stream_main_path"]["first_32_steps_param_err"], card))
    small = max(coupling_errs.values())
    kernels.extend(coupling_kernel_rows(
        *coupled, coupling_launches,
        {"fwd": max(small, report["declined_chain_max_abs_err"]),
         "bwd": max(small, report["each_step_max_abs_err_same_weights"])},
        card))

    # the numbers of the earlier lines once more, near the end of the output
    say(phase="summary", gradient_max_abs_err=err_g, **summary)
    say(phase="done", seconds=time.time() - t_start)
    print(card, flush=True)
    say(kernels=kernels)
    say(ok=True, device={"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
