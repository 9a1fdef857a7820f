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
  and a chain the chain kernel declines (``log_prob`` / ``sample``);
- the other base distributions, spline / MAF / IAF flows and condition
  embeddings, which have no kernel of their own: the flagship split chain
  with a ``DiagNormal`` and a ``GaussianMixture`` base (``log_prob`` /
  ``sample`` / ``sample_sweep`` on ``chain_apply``, never ``chain_sample``)
  and a ``BoxUniform`` base through ``save_flow`` → ``load_flow``; the RQS
  chain of ``benchmarks/spline_crossover.py``'s widest config (d 32, n 8,
  4 blocks of hidden 256, K 8) and ``build_flow(FlowConfig(family="maf"))``
  plus an IAF flow at the same width, each against the same modules in
  float64 on the CPU; ``embed_conditions`` around the flagship chain
  (sampling on ``chain_apply``, ``log_prob`` per-layer, 4 epochs of
  ``train()``); and the coupling main path with its first block an RQS
  block under ``set_fused_kernels(True)`` (``coupling_fwd`` /
  ``coupling_bwd`` on its RealNVP layers only);
- the inference engine: ``flow_mcmc`` (independence and NeuTra, 4,096
  chains, each step one ``chain_apply`` fold) on the flagship split chain
  against its own density, ``sample_with_rejection`` and ``sbc_ranks``;
  then at the README / BASELINE widths a conjugate-Gaussian posterior (θ
  ∈ R⁵ given x ∈ R⁵): ``fit_posterior_rounds`` (3 SNPE-B rounds of 1,000
  simulations on ``train_run``, proposals on ``chain_sample`` /
  ``chain_apply``), ``fit_posterior_apt``, ``run_smc`` at d 32 and
  ``systematic_resample_sharded`` on a one-rank NCCL group;
- the deep ensemble and the precision options: ``train_ensemble`` at the
  README / BASELINE config with 5 members in one ``train_run`` launch of 5
  blocks (each member equal to its own one-member launch), against 5
  launches and the plain program over 10 epochs (member after member, and
  vmapped over the members), a sweep of the member count,
  the mixture's ``log_prob`` / ``sample`` at 2^18 rows (5 ``chain_apply``
  launches a call) and ``save_ensemble`` → ``load_ensemble``; at the
  flagship width ``train(mixed_precision=True)`` against the f32 program,
  ``remat``'s gradients and peak memory, a ``cast_conditioners`` chain
  through ``chain_apply`` / ``chain_sample``; and the port's
  ``uncertainty_and_mcmc`` example at its own budgets;
- ``mesh=`` and tensor parallelism: ``log_prob`` / ``sample`` /
  ``sample_sweep`` and the four particle entry points of the inference
  engine with ``mesh=`` of a one-rank NCCL group against the calls without
  it, ``chain_sample``'s row offset (a 4-way split of 2^18 + 3 rows joined
  against one launch), then this script as two gloo ranks on the one card
  (``--mesh-rank``): a (2, 1) data mesh serving the flagship chain at 2^18
  rows, a (1, 2) model mesh training it tensor-parallel against the
  replicated chain; the instruments (``StepTimer``, ``trace`` /
  ``annotate``, ``Throughput``), ``scaling_report`` at
  ``benchmarks/scaling.py``'s config, and the probe behind the decision on
  the row-chunked folds at 2^18 rows (ROADMAP A.6);
- sharded checkpoints (``utils/orbax_ckpt.py``): the two ranks' tensor-
  parallel chain and Adam state through ``save_flow_orbax`` (each rank
  file holding only its shards, read from the store's metadata), loaded in
  one process and served at 2^18 rows on one ``chain_apply`` / one
  ``chain_sample`` launch against the gathered chain, and loaded onto the
  (1, 2) mesh for 4 more steps against the run that went on; and a round
  trip of the trained README / BASELINE flow on the one-rank NCCL group.

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
from densityflows_tpu_torch import _build, inference as inf, native
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.models import fused_train as ft
from densityflows_tpu_torch.ops import chain_kernels as ck
from densityflows_tpu_torch.ops import coupling as cpl
from densityflows_tpu_torch.ops import coupling_kernels as cpk
from densityflows_tpu_torch.ops.made import MaskedMLP
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
    not counted (the profiler can miss a session's first launches). A
    profile that caught fewer than ``per_call`` launches is taken again, up
    to ``4 * calls`` profiles in all."""
    from torch.profiler import ProfilerActivity, profile

    runs = []
    for _ in range(4 * calls):
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
        if len(events) >= per_call:
            runs.append(events[-per_call:])
        if len(runs) == calls:
            break
    if len(runs) < calls:
        fail(f"the profiler caught {per_call} launches in {len(runs)} of "
             f"{4 * calls} profiles")
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
    """Overwrite every weight of the chain's MLPs (conditioners, spline, MADE
    and embedding nets, in forward order) with a glorot-uniform numpy draw;
    final layers are scaled down so exp(s) stays finite through the chain."""
    with torch.no_grad():
        for net in chain.modules():
            if isinstance(net, (dt.MLP, MaskedMLP)):
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
    # the layouts the lowering falls back to, and small evaluation tiles
    # (ragged in both splits): the same run on each, against the plain
    # version
    d, n_cond = case.arrays[0].shape[1], case.arrays[1].shape[1]
    case = TrainCase(ref, data, device, rng)
    want = case.run(tk.fused_train_plain, w=case.w, w_valid=case.wv,
                    track_best=True)
    layouts = {}
    for paired, segs, rows in ((True, 4, 7), (True, 2, None),
                               (False, 1, 50)):
        packed = tk.pack_train_plan(case.plan, case.tparams, case.masks,
                                    case.slots, case.cparams, d, n_cond,
                                    case.batchsize, paired=paired,
                                    grad_segments=segs, eval_rows=rows)
        name = f"paired_{paired}_segments_{segs}_eval_rows_{packed.eval_rows}"
        errs[name] = require_runs_close(
            case.run(tk.run_fused_train, w=case.w, w_valid=case.wv,
                     track_best=True, packed=packed),
            want, f"train_run {name}", TRAIN_TOL)
        layouts[name] = tk.run_layout(packed, case.n_rows,
                                      case.arrays[2].shape[0])
    # the last layout the lowering tries (the batch's partial sums in the
    # scalar area): what it picks under a limit of the state's floats plus
    # the step kernel's layout of one batch
    head = (case.plan, case.tparams, case.masks, case.slots, case.cparams,
            d, n_cond, case.batchsize)
    step = tk.pack_train_plan(*head, state_in_shared=False)
    limit, tk.MAX_SHARED_BYTES = tk.MAX_SHARED_BYTES, 4 * (
        4 * step.n_params + step.flat_consts.numel() + step.total_floats)
    try:
        packed = tk.pack_train_plan(*head)
        if packed.shared_bytes > tk.MAX_SHARED_BYTES:
            fail(f"train_run: no layout within {tk.MAX_SHARED_BYTES} bytes, "
                 f"the state plus one batch")
    finally:
        tk.MAX_SHARED_BYTES = limit
    name = f"smallest_partial_sums_{packed.prog[tk._H_PARTS].item()}"
    errs[name] = require_runs_close(
        case.run(tk.run_fused_train, w=case.w, w_valid=case.wv,
                 track_best=True, packed=packed),
        want, f"train_run {name}", TRAIN_TOL)
    layouts[name] = tk.run_layout(packed, case.n_rows, case.arrays[2].shape[0])
    default = tk.pack_train_plan(*head)
    layouts["default"] = dict(
        tk.run_layout(default, case.n_rows, case.arrays[2].shape[0]),
        grad_segments=default.grad_segments)
    return errs, {"nan_rows": skipped, "lr_100": exploded,
                  "layouts": layouts}


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


# train()'s stream mode at the shape of the benchmark's emulator32.train cell
# (perfbench/configs/emulator32.json): 8 RealNVP couplings in 4 blocks, split
# s / t nets 24-256-256-(16) with ReLU, batch 8192. A step's products: the
# forward and two backward products of 1,212,416 multiply-adds a row, three
# TF32 products each (3xTF32).
CELL = dict(rows=4 * 8192, batch=8192, epochs=2, macs_per_row=1_212_416)


def leaf_gap(got, want):
    """``perfbench/check.py``'s leaf number: the widest ``|‖a‖ − ‖r‖| /
    max(‖r‖, median leaf ‖r‖)`` over leaves whose reference is above a
    thousandth of the median leaf's."""
    na = [float(t.double().norm()) for t in got]
    nr = [float(t.double().norm()) for t in want]
    med = float(np.median(nr))
    return max(abs(a - r) / max(r, med) for a, r in zip(na, nr)
               if r > 1e-3 * med)


def cell_chain(rng, device):
    """perfbench's emulator32 chain (realnvp_flow with blocks) on random
    weights."""
    kw = dict(n=N_COND, hidden_dim_s=HIDDEN, hidden_dim_t=HIDDEN,
              n_sublayers_s=2, n_sublayers_t=2, activation_s="relu",
              activation_t="relu", device=device)
    x_ref = rng.normal(size=(512, D)).astype(np.float32)
    chain = dt.flow_chain(
        *[dt.coupling_block(D, list(range(D // 2, D)), **kw)
          for _ in range(N_BLOCKS)],
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))
    return numpy_weights_(chain, rng, 0.25)


def wide_stream(rng, device):
    """train() at the emulator32.train cell's shape (CELL): past
    train_run's shared memory, so the default routing takes the stream
    mode, and the launch rule its tensor-core design; the plain program on
    the same weights and batch order beside it. Then the kernel alone on
    the same run in each design (the tile body forced), ms a step, against
    the bound: the step's products in 3xTF32 at the TF32 rate."""
    rows, batch, epochs = CELL["rows"], CELL["batch"], CELL["epochs"]
    x, th01 = data(rng, rows, D, N_COND, "cpu")
    arrays = dt.DataArrays.make(x.numpy(), th01.numpy(), rng=0)
    flow = dt.Flow(cell_chain(rng, device), arrays, device=device)
    plain = dt.Flow(copy.deepcopy(flow.model), arrays, device=device)
    n_train = len(arrays.partition.training)
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED), epochs,
                                n_train)
    tk.run_fused_train.launches = 0
    stk.run_fused_train_stream.launches = 0
    stk.run_fused_train_stream.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a decline warns
        dt.train(flow, arrays, epochs=epochs, batchsize=batch, verbose=False,
                 _epoch_perms=perms)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = stk.run_fused_train_stream.launches
    tc_launches = stk.run_fused_train_stream.tc_launches
    if flow.trained_path != "fused" or flow.fused_kernel_mode != "stream" \
            or launches != 1 or tc_launches != 1 \
            or tk.run_fused_train.launches != 0:
        fail(f"wide chain: train took {flow.trained_path} / "
             f"{flow.fused_kernel_mode} with {launches} train_stream "
             f"launches ({tc_launches} tensor-core; "
             f"{flow.fused_decline_reason})")
    # the kernel alone on the same run, from the same starting weights, in
    # each design (the tile body forced), held against its plain version
    # at the cell's training limits (perfbench/limits/emulator32.train.json):
    # the first step's gradient through Adam's first moment, every step's
    # loss and the run's change of the weights
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(plain.model)
    sp = ft.fold_for_step(plain).step_plan
    xt, tht = arrays.normalized_training_data(plain.metadata)
    xt, tht = put(xt, device), put(tht, device)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, xt, tht)
    rows0 = perms[0, :batch]
    one = (xt[rows0], tht[rows0], np.arange(batch)[None])   # the first step
    kw = dict(batchsize=batch, with_losses=True)
    want = stk.fused_train_stream_plain(*head, perms, **kw)
    want1 = stk.fused_train_stream_plain(*head[:7], *one, **kw)
    steps = epochs * -(-n_train // batch)
    ms, gaps = {}, {}
    for tc in (True, False):
        with stream_design(tc):
            got = stk.run_fused_train_stream(*head, perms, step_plan=sp, **kw)
            got1 = stk.run_fused_train_stream(*head[:7], *one, step_plan=sp,
                                              **kw)
            torch.cuda.synchronize()
            gaps[tc] = dict(
                grad_gap=leaf_gap(got1[1], want1[1]),   # mu = (1 - b1) g
                step_gap=leaf_gap([u - p for u, p in zip(got[0], tparams)],
                                  [u - p for u, p in zip(want[0], tparams)]),
                loss_gap=float(((got[5] - want[5]).abs()
                                / (1 + want[5].abs())).max()))
            ms[tc] = time_ms(lambda: stk.run_fused_train_stream(
                plan, tparams, masks, slots, cparams, zeros, zeros, xt, tht,
                perms, batchsize=batch, step_plan=sp), warmup=1,
                runs=3) / steps
        limits = dict(grad_gap=2.5e-5, step_gap=1e-3, loss_gap=1e-5)
        if not all(gaps[tc][k] <= v for k, v in limits.items()):
            fail(f"wide chain: train_stream's "
                 f"{'tensor-core design' if tc else 'tile body'} against "
                 f"its plain version: {gaps[tc]} (limits {limits})")
    shape = stk.device_launch_shape(sp, batch)
    t0 = time.time()
    dt.train(plain, arrays, epochs=epochs, batchsize=batch, verbose=False,
             fused_kernel=False, _epoch_perms=perms)
    torch.cuda.synchronize()
    plain_seconds = time.time() - t0
    for f in (flow, plain):
        if not np.isfinite(f.valid_loss).all() or len(f.valid_loss) != 2:
            fail(f"wide chain: histories {f.train_loss} / {f.valid_loss}")
    hist_err = float(np.abs(np.asarray(flow.valid_loss)
                            - np.asarray(plain.valid_loss)).max())
    if hist_err > 5e-2:
        fail(f"wide chain: validation NLL {flow.valid_loss} vs the plain "
             f"program's {plain.valid_loss}")
    flops = 3 * 2 * CELL["macs_per_row"] * batch
    return dict(rows=rows, batchsize=batch, epochs=epochs, steps=steps,
                train_stream_launches=launches,
                design="tensor-core" if shape.tc else "tile body",
                train_stream_ms_per_step=1e3 * seconds / steps,
                kernel_alone_ms_per_step=ms[True],
                tile_body_ms_per_step=ms[False],
                plain_program_ms_per_step=1e3 * plain_seconds / steps,
                bound_ms_per_step_3xtf32=1e3 * 3 * flops / PEAK_TF32_FLOPS,
                folded_parameters=sp.n_params, tile_rows=shape.tile,
                threads=shape.threads, shared_bytes=shape.shared_bytes,
                blocks=shape.n_blocks,
                workspace_bytes=stk.stream_workspace_bytes(sp, batch),
                valid_nll=flow.valid_loss, valid_nll_plain=plain.valid_loss,
                valid_history_err_vs_plain=hist_err,
                kernel_alone_vs_plain=gaps[True],
                tile_body_vs_plain=gaps[False])


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


def train_run_at(threads, head, arrays, perms, **kw):
    """One ``train_run`` launch of one member at ``threads`` threads a
    block, on the current stream (``run_fused_train`` takes the default
    count)."""
    plan, tparams, masks, slots, cparams, mu, nu = head
    stream = torch.cuda.current_stream().cuda_stream
    return tk._train_run_members(
        lambda *a: tk._library().df_train_run_members(*a, stream), plan,
        [tparams], masks, slots, cparams, [mu], [nu], *arrays, [perms],
        threads=threads, **kw)[0]


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
    by_threads = {t: time_ms(lambda: train_run_at(
        t, head, arrays, perms, **full), warmup=0, runs=3)
        for t in (256, 512)}
    plain = time_ms(lambda: tk.fused_train_plain(
        *head, *arrays, perms, **kw), warmup=0, runs=3)

    epochs = perms.shape[0]

    def program():
        f = baseline_flow(dataset, {"x": dataset.x}, device, SEED)
        dt.train(f, dataset, epochs=epochs, batchsize=TRAIN_BATCH,
                 verbose=False, fused_kernel=False, _epoch_perms=perms)
    program_ms = time_ms(program, warmup=0, runs=3)

    b_ms, by, flops, nbytes = train_run_bound(chain, n_train, n_valid, d,
                                              n_cond, epochs, packed)
    n_pad = -(-n_train // TRAIN_BATCH) * TRAIN_BATCH
    layout = tk.run_layout(packed, n_train, n_valid)
    layout.update(grad_segments=packed.grad_segments,
                  threads=tk._block_threads(packed))
    say(phase="train_times", card=card, epochs=epochs,
        train_run_ms=ms, train_run_ms_per_epoch=ms / epochs,
        train_run_ms_by_threads=by_threads, train_run_layout=layout,
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
        "layout": layout, "eval_tile_rows": packed.eval_rows,
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


@contextlib.contextmanager
def stream_design(tc):
    """train_stream's launch rule replaced for the block: every plan the
    tensor-core design can run takes it (``tc``), or none does."""
    rule = stk.uses_tc
    stk.uses_tc = ((lambda sp, batchsize: stk.tc_reason(sp) is None) if tc
                   else (lambda sp, batchsize: False))
    try:
        yield
    finally:
        stk.uses_tc = rule


def check_stream_small_designs(rng, device):
    """check_stream_small under each design: the tile body, then the
    tensor-core design wherever it can run the chain (the ActNorm chains
    keep the tile body); the second's cases named ``tc_<case>``."""
    errs, skips = {}, {}
    for tc in (False, True):
        before = stk.run_fused_train_stream.tc_launches
        with stream_design(tc):
            e, k = check_stream_small(rng, device)
        ran = stk.run_fused_train_stream.tc_launches - before
        if bool(ran) != tc:
            fail(f"train_stream small cases: {ran} tensor-core launches "
                 f"with the design {'forced' if tc else 'off'}")
        pre = "tc_" if tc else ""
        errs.update({pre + k2: v for k2, v in e.items()})
        skips.update({pre + k2: v for k2, v in k.items()})
        skips[pre + "tc_launches"] = ran
    return errs, skips


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
        orbax = orbax_round_trip(flow, state, dat, mesh, device, tmp)
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
        valid_nll=flow.valid_loss, sharded_ckpt_round_trip=orbax)


def orbax_round_trip(flow, state, dat, mesh, device, tmp):
    """``save_flow_orbax`` / ``load_flow_orbax`` of the trained flow and its
    Adam state on the one-rank NCCL group (CUDA tensors): ``log_prob`` of
    the data set and the state bit for bit."""
    from densityflows_tpu_torch.utils.orbax_ckpt import (
        load_flow_orbax,
        save_flow_orbax,
    )

    path = os.path.join(tmp, "orbax")
    t0 = time.perf_counter()
    save_flow_orbax(path, flow, state)
    save_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, back_state = load_flow_orbax(path, dt.adam(1e-3), mesh=mesh,
                                       device=device)
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    x = dat["x"].astype(np.float32)
    theta = dat["theta"].astype(np.float32)
    with torch.no_grad():
        lp, lp_back = flow.log_prob(x, theta), back.log_prob(x, theta)
    if not (bits_same(lp, lp_back) and bool(torch.isfinite(lp).all())):
        fail("sharded checkpoint on the NCCL group: log_prob differs")
    if back_state.count != state.count or not all(
            bits_same(a, b) for a, b in zip(back_state.mu + back_state.nu,
                                            state.mu + state.nu)):
        fail("sharded checkpoint on the NCCL group: the Adam state differs")
    return dict(backend="nccl", save_seconds=save_seconds,
                load_seconds=load_seconds, rows=len(x),
                log_prob_and_adam_state="bit for bit",
                bytes=sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(path) for f in files))


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
    # coupling_fwd's calls on the tensor cores are each a weight tiling
    # launch and a fold launch
    return dict(ck.launch_counts(), train_run=tk.run_fused_train.launches,
                step_grads=sk.run_fused_grads.launches,
                train_stream=stk.run_fused_train_stream.launches,
                coupling_fwd_tc=cpk.coupling_fwd.tc_launches,
                coupling_fwd_tile=cpk.coupling_fwd.tile_launches,
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
                        coupling_fwd_tc=0, coupling_fwd_tile=0,
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
    with stream_design(True):     # the design the rule leaves aside here
        tc_ms = time_ms(kernel, warmup=1, runs=3)
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

    tile, threads, shared, n_blocks, staged, tc = stk.device_launch_shape(
        sp, batch)
    co_resident = stk.co_resident_blocks(threads, shared, tc)
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
        design="tensor-core" if tc else "tile body",
        train_stream_ms_per_epoch=ms, train_stream_ms_per_step=ms / n_batches,
        tensor_core_design_ms_per_epoch=tc_ms,
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
        "ms": ms, "tensor_core_design_ms": tc_ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": by,
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


def gate_ratio(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|) where the plain version is
    finite: at most 1 passes the gate."""
    ok = torch.isfinite(want)
    if not bool(ok.any()):
        return 0.0
    got, want = got[ok].detach(), want[ok].detach()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def check_coupling_case(rng, device, name, rows, K=6, A=4, hidden=18, n_s=2,
                        n_t=2, act="relu", bias=True, kinds=("nvp", "nice"),
                        nan_row=False, tc=True, ratios=None):
    """Both kernels against their plain versions, both directions, the
    forward with and without ldj, twice (the same bits) and on the body
    the shape takes (``tc``: the tensor cores, else the FMA body), the
    backward with a non-zero g_ldj and twice. K 6 / A 4 / hidden 18 is d 7, n 3,
    h 18. ``nan_row``: a NaN in a row of h; for the forward also +inf in
    another row of h, NaN and -inf in rows of y. ``ratios``: a dict that
    gets each kernel's largest gate ratio (KERNEL_TOL)."""
    worst = 0.0
    ratios = {} if ratios is None else ratios
    ratios.update(fwd=0.0, bwd=0.0)
    for kind in kinds:
        s, t = coupling_nets(rng, kind, K, A, hidden, n_s, n_t, act, bias,
                             device)
        h = rng.normal(size=(rows, K))
        y = rng.normal(size=(rows, A))
        h_f, y_f = h.copy(), y.copy()
        if nan_row:
            h[min(3, rows - 1), 1] = h_f[min(3, rows - 1), 1] = np.nan
            h_f[min(5, rows - 1), 0] = np.inf
            y_f[min(7, rows - 1), A - 1] = -np.inf
            y_f[min(9, rows - 1), 0] = np.nan
        h, y, gy, h_f, y_f = (put(a, device) for a in
                              (h, y, rng.normal(size=(rows, A)), h_f, y_f))
        gl = put(rng.normal(size=rows), device)
        for direction in ("forward", "inverse"):
            tag = f"coupling {name} {kind} {direction}"
            for with_ldj in (True, False):
                before = cpk.coupling_fwd.tc_launches
                got = cpk.coupling_fwd(s, t, h_f, y_f, direction=direction,
                                       with_ldj=with_ldj)
                again = cpk.coupling_fwd(s, t, h_f, y_f, direction=direction,
                                         with_ldj=with_ldj)
                torch.cuda.synchronize()
                if (cpk.coupling_fwd.tc_launches - before == 2) != tc:
                    fail(f"{tag}: coupling_fwd did not take the "
                         f"{'tensor-core' if tc else 'FMA'} body "
                         f"({cpk.tc_reason(s, t, K, A)})")
                if not all(bits_equal(a, b) for a, b in zip(
                        flat_tensors(got), flat_tensors(again))):
                    fail(f"{tag}: two coupling_fwd launches differ")
                want = cpk.coupling_fwd_plain(s, t, h_f, y_f,
                                              direction=direction,
                                              with_ldj=with_ldj)
                for i, (a, b) in enumerate(zip(flat_tensors(got),
                                               flat_tensors(want))):
                    worst = max(worst, require_close_nan(
                        a, b, f"{tag} coupling_fwd ldj={with_ldj} out {i}"))
                    ratios["fwd"] = max(ratios["fwd"],
                                        gate_ratio(a, b, **KERNEL_TOL))
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
                ratios["bwd"] = max(ratios["bwd"],
                                    gate_ratio(a, b, **KERNEL_TOL))
            if not all(bits_equal(a, b) for a, b in zip(got, again)):
                fail(f"{tag}: two coupling_bwd launches differ")
    return worst


def check_coupling_small(device):
    """Every case's largest error (KERNEL_TOL) and each kernel's largest
    gate ratio, by case."""
    rng = np.random.default_rng(SEED + 5)
    errs, ratios = {}, {}

    def case(key, *args, **kw):
        ratios[key] = {}
        errs[key] = check_coupling_case(rng, device, *args,
                                        ratios=ratios[key], **kw)

    case("d7_n3_h18_rows_1001", "d7", 1001)
    case("rows_37", "rows 37", 37, act="tanh")
    case("rows_5_below_one_tile", "rows 5", 5)
    case("n_s_1_n_t_3", "n_s 1 n_t 3", 300, n_s=1, n_t=3, kinds=("nvp",))
    case("one_dense_layer", "one layer", 300, n_s=0, n_t=0)
    case("no_bias", "no bias", 300, bias=False, act="elu")
    case("nan_row", "NaN row", 64, nan_row=True)
    case("main_shape", "K24 A16 H256", COUPLING["batch"], K=24, A=16,
         hidden=256, kinds=("nvp",))
    for act in ACTIVATIONS:
        case(f"act_{act}", f"act {act}", 257, act=act, kinds=("nvp",))
    # the tensor-core forward at its other row tiles (64 is the default at
    # every shape above), NaN and +-inf rows at each
    for tb in (32, 16):
        cpk.set_tile_rows(tb)
        try:
            case(f"tc_tile_{tb}_rows_1001", f"tile {tb}", 1001, act="gelu")
            case(f"tc_tile_{tb}_nan_inf_rows", f"tile {tb} NaN/inf", 77,
                 nan_row=True)
        finally:
            cpk.set_tile_rows(None)
    # hidden widths whose weights tile in 128-column chunks (100), in passes
    # of 256 columns and a 128-column chunk (300, row tile 32) and a
    # 32-column one (520, row tile 16), each on NaN and +-inf rows too.
    # Smooth activations at these widths: relu's derivative jumps at 0, and
    # among 10^5..10^6 pre-activations one lies within f32 rounding of 0
    # often enough that two correct sum orders take opposite sides of it
    # (a whole delta entry apart in the backward; measured against float64
    # at hidden 3,000 and 300 rows)
    for hid in (100, 300, 520):
        case(f"tc_hidden_{hid}", f"hidden {hid}", 301, K=9, A=5, hidden=hid,
             act="silu")
        case(f"tc_hidden_{hid}_nan_inf_rows", f"hidden {hid} NaN/inf", 77,
             hidden=hid, nan_row=True, act="gelu")
    # the FMA body where the fold's tile does not fit (the stated shape
    # rule, cpk.tc_reason): a hidden layer of 3,000, both kinds, on NaN and
    # +-inf rows too
    case("fma_hidden_3000", "hidden 3000", 300, hidden=3000, act="tanh",
         tc=False)
    case("fma_hidden_3000_nan_inf_rows", "hidden 3000 NaN/inf", 64,
         hidden=3000, nan_row=True, act="tanh", tc=False)
    return errs, ratios


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


def coupling_counts(fwd, bwd, per_bwd=0, tc=None):
    """Launch counts of ``fwd`` coupling_fwd calls (``tc`` of them, all by
    default, on the tensor cores: the weight tiling and the fold) and
    ``bwd`` coupling_bwd calls of ``per_bwd`` launches each
    (``cpk.bwd_launches``: a product launch per layer of the forward and of
    the backward, and the pullback) plus one reduction each."""
    tc = fwd if tc is None else tc
    return dict(chain_apply=0, chain_sample=0, train_run=0, step_grads=0,
                train_stream=0, coupling_fwd=fwd, coupling_fwd_tc=tc,
                coupling_fwd_tile=tc, coupling_bwd=bwd * per_bwd,
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
    def fwd():
        return cpk.coupling_fwd(s, t, h, y, direction="inverse")

    ms_f = time_ms(fwd, runs=15)
    # the forward split: host enqueue and back-to-back pace per call, each
    # kernel's device time (the weight tiling, the fold)
    host_f, pace_f = host_split_ms(fwd, reps=200)
    dev_f = device_ms_by_kernel(fwd)
    tc_plan = cpk.tc_plan(s, t, K, A, "inverse")
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

    # the forward at the row tiles the fold takes (the default: 64); the
    # backward at other row segment counts of its dW products
    by_tile = {}
    for tb in ck.TILE_ROWS:
        cpk.set_tile_rows(tb)
        try:
            by_tile[tb] = dict(
                tile_taken=cpk.tc_plan(s, t, K, A, "inverse").tile_rows,
                fwd=time_ms(fwd, runs=7))
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
    # the forward on the tensor cores: three TF32 products per f32 product
    bf_ms, bf_by = bound_ms(3 * flops_f, bytes_f, PEAK_TF32_FLOPS)
    bf32_ms = bound_ms(flops_f, bytes_f)[0]
    bytes_b = 4 * (B * (K + 2 * A + 1) + n_par + B * (K + A) + n_par)
    bb_ms, bb_by = bound_ms(3 * flops_f, bytes_b)
    n_c = sum(isinstance(c, dt.RNVPCouplingLayer)
              for c in fc._iter_layers(start, "fwd"))
    say(phase="coupling_times", card=card, rows=B, K=K, A=A, hidden=HIDDEN,
        coupling_fwd_ms=ms_f, coupling_fwd_host_enqueue_ms=host_f,
        coupling_fwd_back_to_back_ms=pace_f,
        coupling_fwd_device_ms_by_kernel=dev_f,
        coupling_fwd_workspace_bytes=4 * (tc_plan.bias_floats
                                          + tc_plan.tiled_floats),
        coupling_bwd_ms=ms_b,
        coupling_bwd_device_ms_by_kernel=by_kernel,
        coupling_bwd_device_ms_by_launch=by_launch,
        coupling_bwd_host_enqueue_ms=host_ms, coupling_bwd_segments=segs,
        coupling_bwd_ms_by_segments=by_segs,
        coupling_bwd_launches_per_call=cpk.bwd_launches(s, t),
        coupling_fwd_plain_ms=plain_f,
        coupling_bwd_plain_ms=plain_b, coupling_fwd_bound_ms=bf_ms,
        coupling_fwd_bound_ms_f32_rate=bf32_ms,
        coupling_bwd_bound_ms=bb_ms, step_ms_per_layer_kernels=step_ms[True],
        step_ms_plain_autograd=step_ms[False],
        step_kernel_bound_ms=n_c * (bf_ms + bb_ms),
        tile_rows=tc_plan.tile_rows,
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
             bound_rate="TF32 (3 products per f32 product)",
             bound_ms_f32_rate=bf32_ms,
             needed_flops=3 * flops_f, needed_bytes=bytes_f,
             gate_ratio_small_cases=errs["fwd_gate_ratio"],
             gate_ratio_main_shape=errs["fwd_gate_ratio_main_shape"],
             tile_rows=tc_plan.tile_rows, host_enqueue_ms=host_f,
             device_ms_by_kernel=dev_f,
             tensor_core_launches=launches["coupling_fwd_tc"],
             tiling_launches=launches["coupling_fwd_tile"],
             body=("tensor cores, 3xTF32 (csrc/wgmma_fold.cuh), after a "
                   "weight tiling launch; the f32 FMA body where the "
                   "fold's tile does not fit (cpk.tc_reason)"),
             **common),
        dict(name="coupling_bwd",
             replaces="densityflows_tpu/ops/pallas_coupling.py:263",
             launches=launches["coupling_bwd"], max_abs_err=errs["bwd"],
             ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms, bound_by=bb_by,
             needed_flops=3 * flops_f, needed_bytes=bytes_b,
             gate_ratio_small_cases=errs["bwd_gate_ratio"],
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


# -- phase 4g: the other bases, spline / MAF / IAF / embedded flows ------------

# the serving gates: kernel route against the per-layer path, and the card
# against the same port modules in float64 on the CPU
SERVE_TOL = dict(rtol=1e-4, atol=1e-3)
# rows of the float64 CPU references
REF_ROWS = 4096
# MAF sampling makes d sequential MADE passes a layer: the MAF / IAF
# phase's draws are cut to 2^16
SEQ_ROWS = 1 << 16


@contextlib.contextmanager
def kernel_policy(mode):
    dt.set_fused_kernels(mode)
    try:
        yield
    finally:
        dt.set_fused_kernels("auto")


def counted(fn):
    """``(fn(), launch counts)`` with every count set to 0 just before the
    call and read just after it."""
    reset_counts()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def launches_are(counts, **want):
    """The counts are ``want`` and 0 for every other kernel."""
    return counts == {k: want.get(k, 0) for k in counts}


def require_close_pattern(got, want, what, rtol, atol):
    """NaN and +-inf where ``want`` has them, ``rtol`` / ``atol`` elsewhere."""
    got, want = got.detach().to(want.device, want.dtype), want.detach()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail(f"{what}: NaN pattern differs from the reference")
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf])):
        fail(f"{what}: +-inf pattern differs from the reference")
    ok = torch.isfinite(want)
    return require_close(got[ok], want[ok], what, rtol, atol)


def flagship_inputs(rng, n_cond, rows, device, name):
    """MetaData of the flagship serving config and rows in its θ range."""
    theta_min = np.linspace(-1.0, 0.0, n_cond).astype(np.float32)
    theta_max = np.linspace(1.0, 3.0, n_cond).astype(np.float32)
    meta = dt.MetaData(name, D, n_cond, theta_min, theta_max)
    x, th01 = data(rng, rows, D, n_cond, device)
    theta = (torch.as_tensor(theta_min) + torch.as_tensor(
        theta_max - theta_min) * th01.cpu()).to(device)
    theta_tuple = tuple(float(v) for v in (theta_min + theta_max) / 2)
    return meta, x, theta, theta_tuple


def cpu64(flow):
    """The flow's model on the CPU in float64 and a θ normalizer: the same
    port modules, the reference of the card's float32 run."""
    model = copy.deepcopy(flow.model).to("cpu", torch.float64)
    lo = torch.as_tensor(flow.metadata.theta_min, dtype=torch.float64)
    hi = torch.as_tensor(flow.metadata.theta_max, dtype=torch.float64)

    def theta_n(theta, rows):
        th = torch.as_tensor(theta, dtype=torch.float64)
        th = th.expand(rows, lo.shape[0]) if th.dim() == 1 else th.cpu()
        return dt.normalize_input(th.double(), lo, hi)

    return model, theta_n


def log_prob_ref(flow, x, theta):
    model, theta_n = cpu64(flow)
    with torch.no_grad():
        z, ldj = model.inverse(x.cpu().double(), theta_n(theta, x.shape[0]))
        return flow.base.log_prob(z) + ldj


def sample_ref(flow, seed, total, rows, theta_tuple):
    """The first ``rows`` of ``flow.sample((total,), theta_tuple,
    generator=seed)`` with the standard-normal base: the same torch.randn
    draws, swept in float64 on the CPU."""
    model, theta_n = cpu64(flow)
    r = torch.randn((total, D), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return model.forward_(r[:rows].double(), theta_n(theta_tuple, rows))


def base_moment_z(base, device):
    """max over dims of |mean of 2^18 draws − the analytic mean| over its
    standard error, and the largest relative error of the variance."""
    r = base.sample(torch.Generator().manual_seed(SEED + 5), (ROWS,),
                    device).double()
    if isinstance(base, dt.DiagNormal):
        mean, var = base.mean.double(), base.scale.double() ** 2
    else:
        w = torch.softmax(base.logits.double(), 0)[:, None]
        mu, sc = base.means.double(), base.scales.double()
        mean = (w * mu).sum(0)
        var = (w * (sc ** 2 + mu ** 2)).sum(0) - mean ** 2
    z = float(((r.mean(0) - mean).abs() / (var / ROWS).sqrt()).max())
    var_err = float(((r.var(0) - var) / var).abs().max())
    if not bool(torch.isfinite(r).all()) or z > 5.0 or var_err > 0.05:
        fail(f"{type(base).__name__} draws: z = {z}, variance error "
             f"{var_err}")
    return z, var_err


def drive_bases(device, tmp, card):
    """The flagship split chain (d 32, n 8, 4 coupling blocks of hidden 256,
    normalization; 2^18 rows) with a DiagNormal and a GaussianMixture (K 4)
    base: log_prob, sample and sample_sweep under "auto" (one chain_apply a
    call, no chain_sample: the kernel's in-kernel draw is a standard normal)
    against the per-layer path from the same generator seeds; the base's
    moments; a BoxUniform base through save_flow → load_flow."""
    rng = np.random.default_rng(SEED + 43)
    chain = wide_chain(False, rng, device)
    meta, x, theta, theta_tuple = flagship_inputs(rng, N_COND, ROWS, device,
                                                  "bases")
    bases = {
        "DiagNormal": dt.DiagNormal(rng.normal(size=D) * 0.3,
                                    np.exp(rng.normal(size=D) * 0.2)),
        "GaussianMixture": dt.GaussianMixture(
            rng.normal(size=(4, D)), np.exp(rng.normal(size=(4, D)) * 0.2),
            rng.normal(size=4)),
    }
    report, launches = {}, {}
    for name, base in bases.items():
        flow = dt.Flow(chain, meta, base, device=device)
        calls = {
            "log_prob": lambda: flow.log_prob(x, theta),
            "sample": lambda: flow.sample(
                (ROWS,), theta_tuple,
                generator=torch.Generator().manual_seed(SEED + 1)),
            "sample_sweep": lambda: flow.sample_sweep(
                theta[:64], 4096,
                generator=torch.Generator().manual_seed(SEED + 2)),
        }
        out = {}
        for mode in ("auto", False):
            with kernel_policy(mode):
                for call, fn in calls.items():
                    got, counts = counted(fn)
                    want = (dict(chain_apply=1) if mode == "auto" else {})
                    if not launches_are(counts, **want):
                        fail(f"{name} base, {call} under {mode}: launches "
                             f"{counts}, expected {want or 'none'}")
                    if mode == "auto":
                        launches[f"{name}.{call}"] = counts["chain_apply"]
                    out[(mode, call)] = got
        errs = {call: require_close(out[("auto", call)], out[(False, call)],
                                    f"{name} base: {call}, chain_apply vs "
                                    "the per-layer path", **SERVE_TOL)
                for call in calls}
        z, var_err = base_moment_z(base, device)
        with torch.no_grad():
            lp_ms = time_ms(calls["log_prob"], runs=5)
            s_ms = time_ms(calls["sample"], runs=5)
        report[name] = dict(
            max_abs_err_vs_per_layer=errs, base_draw_z=z,
            base_draw_var_rel_err=var_err, log_prob_ms=lp_ms,
            log_prob_rows_per_s=ROWS / (lp_ms * 1e-3), sample_ms=s_ms,
            sample_draws_per_s=ROWS / (s_ms * 1e-3))
        del out

    # a box around the middle of the latents: a share of the rows falls
    # outside it, and their log_prob is exactly -inf
    with torch.no_grad():
        z, _ = dt.Flow(chain, meta, device=device).inverse(x[:REF_ROWS],
                                                           theta[:REF_ROWS])
    box = dt.BoxUniform(torch.quantile(z, 0.03, dim=0).cpu(),
                        torch.quantile(z, 0.97, dim=0).cpu())
    built = dt.Flow(chain, meta, box, device=device)
    dt.save_flow(f"{tmp}/box", built)
    loaded = dt.load_flow(f"{tmp}/box", device=device)
    lp_l, counts = counted(lambda: loaded.log_prob(x, theta))
    if not launches_are(counts, chain_apply=1):
        fail(f"BoxUniform base, log_prob: launches {counts}")
    launches["BoxUniform.log_prob"] = counts["chain_apply"]
    with torch.no_grad():
        lp_b = built.log_prob(x, theta)
        with kernel_policy(False):
            z_p, ldj_p = built.inverse(x, theta)
    # the loaded flow runs the same kernel on the same weights: the same
    # bits, -inf rows included
    require_close_pattern(lp_l, lp_b, "BoxUniform base: loaded vs built "
                          "log_prob", 0.0, 0.0)
    lp_p = box.to(device).log_prob(z_p) + ldj_p
    outside = int(torch.isneginf(lp_p).sum())
    if not 0 < outside < ROWS:
        fail(f"BoxUniform base: {outside} of {ROWS} rows outside the box")
    # against the per-layer path: the same -inf rows but for a row whose
    # latent lies within 1e-3 of the box's face (the two routes' latents
    # differ by the serving gate), the same values on the rest
    lo, hi = box.lo.to(device), box.hi.to(device)
    near = (((z_p - lo).abs() < 1e-3) | ((z_p - hi).abs() < 1e-3)).any(-1)
    flipped = torch.isneginf(lp_b) != torch.isneginf(lp_p)
    if bool((flipped & ~near).any()):
        fail("BoxUniform base: the -inf rows differ from the per-layer path")
    ok = torch.isfinite(lp_b) & torch.isfinite(lp_p)
    err_box = require_close(lp_b[ok], lp_p[ok], "BoxUniform base: "
                            "log_prob vs the per-layer path", **SERVE_TOL)
    report["BoxUniform"] = dict(rows_outside=outside,
                                rows_flipped_at_the_face=int(flipped.sum()),
                                max_abs_err_vs_per_layer=err_box)
    say(phase="bases_main_path", card=card, rows=ROWS, launches=launches,
        **report)
    return launches, report


def rqs_chain(rng, device):
    """benchmarks/spline_crossover.py's widest config: d 32, n 8, 4 RQS
    coupling blocks of hidden 256, K 8, bound 3, with a normalization
    tail."""
    x_ref = rng.normal(size=(512, D)).astype(np.float32)
    chain = dt.flow_chain(
        *[dt.coupling_block(D, None, n=N_COND, kind=dt.RQSCouplingLayer,
                            hidden_dim_t=HIDDEN, n_bins=8, bound=3.0,
                            device=device) for _ in range(N_BLOCKS)],
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))
    return numpy_weights_(chain, rng, 0.5)


def timed_rates(flow, x, theta, theta_tuple, sample_rows):
    with torch.no_grad():
        lp_ms = time_ms(lambda: flow.log_prob(x, theta), warmup=1, runs=3)
        s_ms = time_ms(lambda: flow.sample(
            (sample_rows,), theta_tuple,
            generator=torch.Generator().manual_seed(SEED)), warmup=1, runs=3)
    return dict(log_prob_ms=lp_ms,
                log_prob_rows_per_s=x.shape[0] / (lp_ms * 1e-3),
                sample_ms=s_ms, sample_rows=sample_rows,
                sample_draws_per_s=sample_rows / (s_ms * 1e-3))


def drive_rqs(device, card):
    """log_prob, sample and inverse(forward(z)) of the spline chain at 2^18
    rows; 4,096 rows of each (rows beyond ±bound and a NaN row among them)
    against the same modules in float64 on the CPU. No kernel covers a
    spline coupling: the run launches none."""
    rng = np.random.default_rng(SEED + 47)
    meta, x, theta, theta_tuple = flagship_inputs(rng, N_COND, ROWS, device,
                                                  "rqs")
    flow = dt.Flow(rqs_chain(rng, device), meta, device=device)
    x[:256] *= 20.0           # spline inputs beyond ±bound
    x[300, 5] = float("nan")
    lp, c_lp = counted(lambda: flow.log_prob(x, theta))
    s, c_s = counted(lambda: flow.sample((ROWS,), theta_tuple,
                                         generator=torch.Generator()
                                         .manual_seed(SEED + 3)))
    z = torch.as_tensor(rng.normal(size=(ROWS, D)).astype(np.float32)
                        ).to(device)
    (xf, ldj_f), c_f = counted(lambda: flow.forward(z, theta))
    (zb, ldj_b), c_b = counted(lambda: flow.inverse(xf, theta))
    for what, c in (("log_prob", c_lp), ("sample", c_s), ("forward", c_f),
                    ("inverse", c_b)):
        if not launches_are(c):
            fail(f"spline chain {what}: launches {c}, expected none")
    if int(torch.isnan(lp).sum()) != 1 or not bool(
            torch.isfinite(s).all()):
        fail("spline chain: expected exactly the one NaN row in log_prob "
             "and finite draws")
    err_lp = require_close_pattern(lp[:REF_ROWS],
                                   log_prob_ref(flow, x[:REF_ROWS],
                                                theta[:REF_ROWS]),
                                   "spline log_prob vs CPU float64",
                                   **SERVE_TOL)
    err_s = require_close_pattern(s[:REF_ROWS],
                                  sample_ref(flow, SEED + 3, ROWS, REF_ROWS,
                                             theta_tuple),
                                  "spline sample vs CPU float64",
                                  **SERVE_TOL)
    err_rt = require_close(zb, z, "spline inverse(forward(z))", 1e-4, 1e-4)
    require_close(ldj_f + ldj_b, torch.zeros_like(ldj_f),
                  "spline ldj_fwd + ldj_inv", 0.0, 1e-3)
    report = dict(config=f"d {D}, n {N_COND}, {N_BLOCKS} RQS coupling "
                         f"blocks hidden {HIDDEN}, K 8, bound 3 + "
                         "normalization",
                  rows=ROWS, log_prob_max_abs_err_vs_cpu64=err_lp,
                  sample_max_abs_err_vs_cpu64=err_s,
                  round_trip_max_abs_err=err_rt, launches=c_lp,
                  **timed_rates(flow, x[512:], theta[512:], theta_tuple,
                                ROWS))
    say(phase="rqs_main_path", card=card, **report)
    return report


def drive_maf(device, card):
    """build_flow(FlowConfig(family="maf", n_blocks=4)) at d 32, n 8, hidden
    256, and an iaf_layer flow of the same width: log_prob on 2^18 rows and
    sample on 2^16 rows (the MAF flow's sampling is d passes a layer), each
    against float64 on the CPU on a subset (1,024 rows where the direction
    is d passes)."""
    rng = np.random.default_rng(SEED + 53)
    meta, x, theta, theta_tuple = flagship_inputs(rng, N_COND, ROWS, device,
                                                  "maf")
    # the config's data: 2^16 rows in the flagship's θ range
    th01 = rng.uniform(size=(SEQ_ROWS, N_COND)).astype(np.float32)
    dset = dt.DataArrays.make(
        (rng.normal(size=(SEQ_ROWS, D)) * 0.5).astype(np.float32),
        meta.theta_min + (meta.theta_max - meta.theta_min) * th01, rng=0)
    cfg = dt.FlowConfig(net=dt.NetConfig(hidden_dim_t=HIDDEN),
                        n_blocks=N_BLOCKS, family="maf")
    maf = dt.build_flow(cfg, dset, generator=torch.Generator()
                        .manual_seed(SEED), device=device)
    numpy_weights_(maf.model, rng, 0.1)
    iaf = dt.Flow(numpy_weights_(dt.flow_chain(
        dt.iaf_layer(D, n=N_COND, hidden_dim=HIDDEN, device=device,
                     generator=torch.Generator().manual_seed(SEED)),
        dt.normalization_layer(dset, -1.0, 1.0, device=device)), rng, 0.1),
        dset, device=device)
    report = {}
    for name, flow, lp_rows, ref_lp, ref_s in (
            ("maf", maf, ROWS, REF_ROWS, 1024),
            ("iaf", iaf, ROWS, 1024, REF_ROWS)):
        lp, c_lp = counted(lambda: flow.log_prob(x[:lp_rows],
                                                 theta[:lp_rows]))
        s, c_s = counted(lambda: flow.sample(
            (SEQ_ROWS,), theta_tuple,
            generator=torch.Generator().manual_seed(SEED + 4)))
        if not (launches_are(c_lp) and launches_are(c_s)):
            fail(f"{name} flow: launches {c_lp} / {c_s}, expected none")
        if not (bool(torch.isfinite(lp).all())
                and bool(torch.isfinite(s).all())):
            fail(f"{name} flow: non-finite log_prob or draws")
        err_lp = require_close_pattern(
            lp[:ref_lp], log_prob_ref(flow, x[:ref_lp], theta[:ref_lp]),
            f"{name} log_prob vs CPU float64", **SERVE_TOL)
        err_s = require_close_pattern(
            s[:ref_s], sample_ref(flow, SEED + 4, SEQ_ROWS, ref_s,
                                  theta_tuple),
            f"{name} sample vs CPU float64", **SERVE_TOL)
        report[name] = dict(
            log_prob_rows=lp_rows, log_prob_max_abs_err_vs_cpu64=err_lp,
            log_prob_ref_rows=ref_lp, sample_max_abs_err_vs_cpu64=err_s,
            sample_ref_rows=ref_s,
            **timed_rates(flow, x[:lp_rows], theta[:lp_rows], theta_tuple,
                          SEQ_ROWS))
    say(phase="maf_main_path", card=card,
        config=f"d {D}, n {N_COND}, hidden {HIDDEN}: {N_BLOCKS} MAF layers "
               "+ permutations + normalization; 1 IAF layer + normalization",
        **report)
    return report


def drive_embed(device, card):
    """embed_conditions(the flagship chain built at n 8, n_raw 64,
    embed_dim 8): sample (one chain_apply, the inner chain's sweep on the
    embedded θ) against the per-layer path, log_prob (per-layer: no chain
    launch, as in JAX), then 4 epochs of train() on the plain program (the
    whole-run kernel declines the model by name)."""
    rng = np.random.default_rng(SEED + 59)
    n_raw = 64
    meta, x, theta, theta_tuple = flagship_inputs(rng, n_raw, ROWS, device,
                                                  "embed")
    model = dt.embed_conditions(wide_chain(False, rng, device), n_raw,
                                N_COND, device=device)
    numpy_weights_(model.embed, rng, 1.0)
    flow = dt.Flow(model, meta, device=device)
    draw = lambda: flow.sample(  # noqa: E731
        (ROWS,), theta_tuple, generator=torch.Generator().manual_seed(SEED))
    s, c_s = counted(draw)
    lp, c_lp = counted(lambda: flow.log_prob(x, theta))
    if not launches_are(c_s, chain_apply=1) or not launches_are(c_lp):
        fail(f"embedded chain: launches sample {c_s}, log_prob {c_lp}; "
             "expected one chain_apply and none")
    with kernel_policy(False), torch.no_grad():
        s_p = draw()
        lp_p = flow.log_prob(x, theta)
    err_s = require_close(s, s_p, "embedded sample vs the per-layer path",
                          **SERVE_TOL)
    err_lp = require_close(lp, lp_p, "embedded log_prob under auto and "
                           "False (both per-layer)", **SERVE_TOL)
    rates = timed_rates(flow, x, theta, theta_tuple, ROWS)

    rows, batch, epochs = 1 << 14, 1024, 4
    xt = (rng.normal(size=(rows, D)) * 0.5).astype(np.float32)
    tht = meta.theta_min + (meta.theta_max - meta.theta_min) * rng.uniform(
        size=(rows, n_raw)).astype(np.float32)
    xt[:, :4] += 0.3 * tht[:, :4]
    dset = dt.DataArrays.make(xt, tht, rng=0)
    tflow = dt.Flow(copy.deepcopy(model), dset, device=device)
    embed0 = [w.detach().clone() for w in tflow.model.embed.weights]
    nll0 = dt.evaluate(tflow, dset, "training")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.time()
        dt.train(tflow, dset, epochs=epochs, batchsize=batch, verbose=False,
                 generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        seconds = time.time() - t0
    reason = tflow.fused_decline_reason or ""
    if tflow.trained_path != "torch" or "EmbeddedChain" not in reason \
            or not any("EmbeddedChain" in str(w.message) for w in caught):
        fail(f"embedded train: path {tflow.trained_path}, reason {reason}")
    tl = np.asarray(tflow.train_loss)
    moved = [float((a - w.detach()).abs().max())
             for a, w in zip(embed0, tflow.model.embed.weights)]
    if not (np.isfinite(tl).all() and tl[-1] < nll0 and min(moved) > 0):
        fail(f"embedded train: NLL {nll0} -> {tl}, embedding moved {moved}")
    report = dict(n_raw=n_raw, embed_dim=N_COND, rows=ROWS,
                  sample_launches=c_s, log_prob_launches=c_lp,
                  sample_max_abs_err_vs_per_layer=err_s,
                  log_prob_max_abs_err_auto_vs_false=err_lp, **rates,
                  train_epochs=epochs, train_rows=rows, train_batch=batch,
                  train_nll_before=nll0, train_nll=tl.tolist(),
                  train_seconds=seconds, embed_weight_max_change=moved,
                  decline_reason=reason)
    say(phase="embed_main_path", card=card, **report)
    return report


def mixed_rqs_start(device):
    """The wide split chain of the coupling main path with its first block
    an RQS block (K 8, bound 3, hidden 256)."""
    rng = np.random.default_rng(SEED + 61)
    chain = wide_chain(False, rng, device)
    rqs = numpy_weights_(dt.coupling_block(
        D, None, n=N_COND, kind=dt.RQSCouplingLayer, hidden_dim_t=HIDDEN,
        device=device), rng, 0.3)
    return dt.flow_chain(rqs, *list(chain.layers)[1:])


def mixed_steps_same_weights(start, batches, steps):
    """The kernels' trajectory replayed on the mixed chain: at every step the
    loss with the kernels against the plain autograd step on the SAME
    weights (KERNEL_TOL, gated), then the kernels' Adam update. Reported per
    step, not gated: the largest gate ratio |err| / (atol + rtol |want|) of
    the gradients, and the one the plain step itself reaches when its input
    moves by one ulp. A spline is C1, not C2: its ldj's derivative jumps at
    a knot, so a row whose spline input lands on the other side of a knot
    (an ulp of rounding suffices) changes every gradient upstream of it by
    more than 1e-4."""
    model = copy.deepcopy(start)
    opt = dt.adam(1e-3)
    state = opt.init(ft.trainable_leaves(model))
    base = dt.StandardNormal(D)
    mask = torch.ones(COUPLING["batch"], device=batches[0][0].device)
    gen = torch.Generator(device=mask.device).manual_seed(SEED)
    loss_errs, grad_ratios, ulp_ratios = [], [], []
    for k in range(steps):
        xb, thb = batches[k % len(batches)]
        sign = torch.randint(0, 2, xb.shape, generator=gen,
                             device=xb.device) * 2 - 1
        got = {}
        for name, mode, xx in (("kernels", True, xb), ("plain", False, xb),
                               ("ulp", False, xb * (1 + sign * 2.0 ** -23))):
            with kernel_policy(mode):
                got[name] = _loss_and_grads(model, base, xx, thb, mask)
        loss_errs.append(require_close(
            got["kernels"][0], got["plain"][0], f"mixed chain step {k + 1} "
            "loss on the same weights", **KERNEL_TOL))
        for name, out in (("kernels", grad_ratios), ("ulp", ulp_ratios)):
            out.append(max(gate_ratio(a, b, **KERNEL_TOL) for a, b in zip(
                got[name][2], got["plain"][2])))
        updates, state = opt.update(got["kernels"][2], state,
                                    got["kernels"][1])
        with torch.no_grad():
            for p, u in zip(got["kernels"][1], updates):
                p.add_(u)
    return loss_errs, grad_ratios, ulp_ratios


def drive_mixed_coupling(device, card):
    """32 steps of make_train_step(adam(1e-3)) on the mixed RQS + RealNVP
    chain at batch 8192 from 2^16 rows under set_fused_kernels(True): the
    RealNVP layers take coupling_fwd / coupling_bwd (launches asserted), the
    RQS layers plain autograd. Gates: every step's loss against the plain
    step on the same weights (1e-4), the 32 steps' losses and parameters
    within max(1e-4 / 1e-3, 3 × the floor of two plain versions); the
    gradients on the same weights are reported beside the ratio one ulp of
    input reaches (mixed_steps_same_weights). Then train() on the chain:
    the whole-run kernel declines it by name."""
    steps, batch = COUPLING["steps"], COUPLING["batch"]
    x, th, batches = coupling_pool(device)
    start = mixed_rqs_start(device)
    rnvp = [layer for layer in start.modules()
            if isinstance(layer, dt.RNVPCouplingLayer)]
    per_bwd = cpk.bwd_launches(*layer_nets(rnvp[0]))
    reset_counts()
    model_k, losses_k, sec_k = coupling_steps(start, batches, True, steps)
    launches = read_counts()
    want = coupling_counts(len(rnvp) * steps, len(rnvp) * steps, per_bwd)
    if launches != want:
        fail(f"mixed chain launches {launches}, expected {want}: "
             f"{len(rnvp)} RealNVP layers a step")
    model_p, losses_p, sec_p = coupling_steps(start, batches, False, steps)
    with plain_coupling_ops():
        model_f, losses_f, _ = coupling_steps(start, batches, True, steps)

    def param_errs(model):
        return [float((a - b).detach().abs().max()) for a, b in zip(
            ft.trainable_leaves(model), ft.trainable_leaves(model_p))]

    floor = max(param_errs(model_f))
    param_tol = max(SHORT_RUN_TOL[1], FLOOR_FACTOR * floor)
    # the spline layers carry the two trajectories' rounding apart faster
    # than the RealNVP chain does: the 32-step losses, like the parameters,
    # are held to FLOOR_FACTOR times the floor two plain versions reach
    # where that exceeds 1e-4 (every step on the same weights stays at 1e-4)
    loss_floor = float((losses_f - losses_p).abs().max())
    loss_tol = max(SHORT_RUN_TOL[0], FLOOR_FACTOR * loss_floor)
    loss_err = require_close(losses_k, losses_p, "mixed chain: 32-step "
                             "losses", 0.0, loss_tol)
    param_err = max(require_close(a, b, f"mixed chain: param {k}", 0.0,
                                  param_tol)
                    for k, (a, b) in enumerate(zip(
                        ft.trainable_leaves(model_k),
                        ft.trainable_leaves(model_p))))
    loss_errs, grad_ratios, ulp_ratios = mixed_steps_same_weights(
        start, batches, steps)

    dataset = dt.DataArrays.make(x, th, rng=0)
    flow = dt.Flow(copy.deepcopy(start), dataset, device=device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dt.train(flow, dataset, epochs=1, batchsize=batch, verbose=False,
                 generator=torch.Generator().manual_seed(SEED))
    reason = flow.fused_decline_reason or ""
    if flow.trained_path != "torch" or "RQSCouplingLayer" not in reason \
            or not any("RQSCouplingLayer" in str(w.message) for w in caught):
        fail(f"mixed chain train: path {flow.trained_path}, reason {reason}")
    report = dict(
        config=f"d {D}, n {N_COND}: 1 RQS block + {N_BLOCKS - 1} RealNVP "
               f"blocks hidden {HIDDEN} + normalization, batch {batch}",
        launches=launches, rnvp_layers=len(rnvp),
        coupling_bwd_launches_per_call=per_bwd, steps=steps,
        each_step_loss_max_abs_err_same_weights=max(loss_errs),
        gradient_gate_ratio_by_step=grad_ratios,
        gradient_gate_ratio_of_one_ulp_by_step=ulp_ratios,
        steps_loss_max_abs_err=loss_err, steps_param_max_abs_err=param_err,
        rounding_floor_loss_err=loss_floor, steps_loss_tolerance=loss_tol,
        rounding_floor_param_err=floor, steps_param_tolerance=param_tol,
        losses_first_last=[float(losses_p[0]), float(losses_p[-1])],
        ms_per_step_kernels=1e3 * sec_k / steps,
        ms_per_step_plain=1e3 * sec_p / steps, decline_reason=reason)
    say(phase="mixed_coupling_path", card=card, **report)
    return report


# -- phase 4h: the inference engine (A12) --------------------------------------

# flow_mcmc on the flagship split chain, the chains and steps of the run
MCMC = dict(chains=4096, steps=300, burn_in=50, neutra_steps=200, step=0.2,
            compare_steps=20, time_steps=50)
# MCMC on the kernels against the per-layer path, the same generator:
# shares of accept decisions that agree, and the draws where they agree
DECISION_AGREEMENT = 0.999
MCMC_TOL = dict(rtol=1e-4, atol=1e-3)
REJECTION_SAMPLES = 1 << 16
SBC = dict(sims=256, draws=256)
# the conjugate-Gaussian posterior at BASELINE's widths: θ ~ N(0, I5),
# x | θ ~ N(θ, 0.5² I5)
# Gates on 2^16 posterior draws at X_OBS, per coordinate: the std within
# 0.1 and, for SNPE-B, the mean within 0.3. Over 8 seeds of this run on the
# CPU (the port's plain program) SNPE-B's largest mean error was 0.054–0.242
# (median 0.12; the std's ≤ 0.07): the fit of a hidden-16 flow to 3,000
# simulations, not the path, sets it (3,000 prior simulations and 400
# epochs still leave 0.09), and the two coordinates with |x_obs| ≥ 1 take
# most of it. The prior itself is 0.96 off. APT on the same simulations:
# ≤ 0.098 over 5 seeds, gate 0.15 on both.
SNPE = dict(d=5, sigma=0.5, rounds=3, sims=1000, epochs=50, batch=64,
            apt_epochs=50, atoms=10, draws=1 << 16, std_gate=0.1,
            mean_gate=0.3, apt_gate=0.15)
X_OBS = np.array([1.0, -0.5, 0.0, 0.8, -1.2], np.float32)
# random-walk moves of 0.3 (about 2.38/√d of the target's scale), 6 a step:
# with the default 0.1 / 2 the 20 steps do not mix the resampled copies
# apart (variance off by up to 0.13 on the CPU, 0.02–0.04 with these)
SMC = dict(d=32, particles=1 << 16, steps=20, mh_step=0.3, n_mh=6, gate=0.05)
RESAMPLE = dict(rows=1 << 20, d=32)


def sbc_null_quantile(n_sims, n_draws, d, q=0.99, reps=2000):
    """The ``q`` quantile of ``sbc_uniformity`` for a calibrated posterior:
    ranks i.i.d. uniform on {0, …, n_draws} for each of d parameters,
    simulated in float64 (independent parameters: their max is the larger
    one, so the level errs to the safe side). For d = 1 the 0.99 quantile
    is the 1.63/√n_sims of one continuous parameter."""
    rng = np.random.default_rng(SEED + 62)
    stats = [inf.sbc_uniformity(rng.integers(0, n_draws + 1,
                                             size=(n_sims, d)), n_draws)
             for _ in range(reps)]
    return float(np.quantile(stats, q))


def rw_acceptance(d, step):
    """Stationary acceptance of random-walk Metropolis with N(0, step² I)
    proposals on N(0, I_d), in float64: given |ε| = ρ the log ratio is
    N(−s²/2, s²) with s = step·ρ, whose mean of min(1, e^Δ) is 2Φ(−s/2) =
    erfc(s / 2√2); averaged over ρ ~ χ_d by the trapezoid rule."""
    import math

    rho = np.linspace(1e-9, math.sqrt(d) + 12.0, 200_001)
    log_pdf = ((d - 1) * np.log(rho) - rho * rho / 2
               - (d / 2 - 1) * math.log(2.0) - math.lgamma(d / 2))
    erfc = np.frompyfunc(math.erfc, 1, 1)
    f = np.exp(log_pdf) * erfc(step * rho / (2.0 * math.sqrt(2.0))
                               ).astype(np.float64)
    return float(np.sum((f[1:] + f[:-1]) / 2 * np.diff(rho)))


def mcmc_decisions(xs):
    """Accept decisions of steps 1.. from successive states (a step that
    accepts moves the chain: the proposal differs from the state)."""
    return (xs[1:] != xs[:-1]).any(-1)


def mcmc_agreement(xs_k, xs_p):
    """Kernel run against the per-layer run from the same generator: the
    share of accept decisions that agree (step 0's from the first states,
    which are the two runs' own proposals or both starts; steps 1.. from
    the states' moves) and the largest gate ratio of the draws of the chains
    whose decisions agreed so far."""
    same0 = ((xs_k[0] - xs_p[0]).abs()
             <= MCMC_TOL["atol"] + MCMC_TOL["rtol"] * xs_p[0].abs()).all(-1)
    agree = torch.cat([same0[None], mcmc_decisions(xs_k)
                       == mcmc_decisions(xs_p)])
    so_far = torch.cumprod(agree.to(torch.int32), 0).bool()
    ratio = ((xs_k - xs_p).abs()
             / (MCMC_TOL["atol"] + MCMC_TOL["rtol"] * xs_p.abs())).amax(-1)
    worst = float(ratio[so_far].max()) if bool(so_far.any()) else 0.0
    return float(agree.double().mean()), worst


def mcmc_moment_z(kept, ess, ref):
    """max over dims of |mean of the kept draws − mean of ``ref``| over
    the standard error of the difference (the draws counted by their ESS),
    and the largest |std ratio − 1|."""
    k = kept.reshape(-1, kept.shape[-1]).double()
    ref = ref.double()
    se = torch.sqrt(k.var(0) / torch.as_tensor(ess, device=k.device)
                    + ref.var(0) / ref.shape[0])
    z = float(((k.mean(0) - ref.mean(0)).abs() / se).max())
    ratio = float((k.std(0) / ref.std(0) - 1).abs().max())
    return z, ratio


def drive_inference(device, card):
    """The inference engine on the flagship split chain (d 32, n 8, 8
    RealNVP couplings of hidden 256, normalization), θ a tuple of 8:

    - flow_mcmc "independence", 4,096 chains, 300 steps, burn-in 50, the
      flow's own log_prob as the target: acceptance ≥ 0.95, the kept draws'
      moments against flow.sample (z ≤ 5, std within 5 %), launches 2 ×
      301 chain_apply (the step's fold and the target's log_prob), no
      chain_sample;
    - flow_mcmc "neutra", step 0.2, 200 steps: the pulled-back target is
      N(0, I₃₂), so the acceptance is within 0.02 of random-walk
      Metropolis's on it (rw_acceptance); launches 2 × 201 chain_apply;
    - both methods, 20 steps from one generator seed on the kernels and on
      the per-layer path: ≥ 99.9 % of the accept decisions agree, and the
      chains whose decisions agreed have the same draws (1e-4 rel + 1e-3
      abs);
    - sample_with_rejection of 2^16 rows, about half accepted: one
      chain_apply a round, every row meets the condition;
    - sbc_ranks, 256 simulations × 256 draws, θ_true drawn from the flow
      itself: one chain_sample launch, sbc_uniformity below its 1 % level
      for 32 parameters (sbc_null_quantile)."""
    rng = np.random.default_rng(SEED + 61)
    chain = wide_chain(False, rng, device)
    meta, _, _, theta_tuple = flagship_inputs(rng, N_COND, 16, device,
                                              "inference")
    flow = dt.Flow(chain, meta, device=device)
    chains = MCMC["chains"]

    def log_density(x):
        return flow.log_prob(x, theta_tuple)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    report, launches = {}, {}
    for method, steps in (("independence", MCMC["steps"]),
                          ("neutra", MCMC["neutra_steps"])):
        kw = dict(theta=theta_tuple, n_chains=chains, method=method,
                  step_size=MCMC["step"])
        reset_counts()
        t0 = time.perf_counter()
        kept, diag = dt.flow_mcmc(flow, log_density, n_steps=steps,
                                  burn_in=MCMC["burn_in"],
                                  generator=gen(SEED + 1), **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        if not launches_are(counts, chain_apply=2 * (steps + 1)):
            fail(f"flow_mcmc {method}: launches {counts}, expected "
                 f"{2 * (steps + 1)} chain_apply and nothing else")
        launches[method] = counts["chain_apply"]
        acc = float(diag["accept_rate"].mean())
        if not bool(torch.isfinite(kept).all()) or \
                kept.shape != (steps - MCMC["burn_in"], chains, D):
            fail(f"flow_mcmc {method}: draws {tuple(kept.shape)}, finite "
                 f"{bool(torch.isfinite(kept).all())}")
        out = dict(accept_rate=acc, seconds=seconds,
                   r_hat_max=float(np.max(diag["r_hat"])),
                   ess_min=float(np.min(diag["ess"])))
        if method == "independence":
            if acc < 0.95:
                fail(f"flow_mcmc independence on the flow's own density: "
                     f"acceptance {acc} < 0.95")
            with torch.no_grad():
                ref = flow.sample((ROWS,), theta_tuple, generator=gen(SEED))
            z, ratio = mcmc_moment_z(kept, diag["ess"], ref)
            if z > 5.0 or ratio > 0.05:
                fail(f"flow_mcmc independence: kept draws' moments against "
                     f"flow.sample: z {z}, std ratio off by {ratio}")
            # the same against the per-layer sampler (torch.randn draws):
            # which of the two samplers a deviation comes from
            with torch.no_grad(), kernel_policy(False):
                ref = flow.sample((ROWS,), theta_tuple, generator=gen(SEED))
            z_plain, _ = mcmc_moment_z(kept, diag["ess"], ref)
            out.update(moment_z=z, std_ratio_err=ratio,
                       moment_z_vs_per_layer_sample=z_plain)
        else:
            want = rw_acceptance(D, MCMC["step"])
            if abs(acc - want) > 0.02:
                fail(f"flow_mcmc neutra: acceptance {acc}, random-walk "
                     f"Metropolis on N(0, I) gives {want}")
            out.update(rw_acceptance_float64=want)
        del kept
        # the kernels against the per-layer path, one generator seed
        runs = {}
        for mode in ("auto", False):
            with kernel_policy(mode):
                runs[mode], _ = dt.flow_mcmc(
                    flow, log_density, n_steps=MCMC["compare_steps"],
                    burn_in=0, generator=gen(SEED + 2), **kw)
        share, ratio = mcmc_agreement(runs["auto"], runs[False])
        if share < DECISION_AGREEMENT or ratio > 1.0:
            fail(f"flow_mcmc {method}: kernels vs per-layer path, "
                 f"{share} of the decisions agree (need "
                 f"{DECISION_AGREEMENT}), draws at {ratio} of the gate")
        del runs
        # the time of a step: the loop alone (one kept step: no
        # diagnostics)
        t_steps = MCMC["time_steps"]
        t0 = time.perf_counter()
        dt.flow_mcmc(flow, log_density, n_steps=t_steps, burn_in=t_steps - 1,
                     generator=gen(SEED + 3), **kw)
        torch.cuda.synchronize()
        out.update(decisions_agree=share, agreed_draws_gate_ratio=ratio,
                   ms_per_step=1e3 * (time.perf_counter() - t0) / t_steps,
                   ms_per_step_with_diagnostics=1e3 * seconds / steps)
        report[method] = out

    # rejection: the condition holds on about half of the flow's draws
    with torch.no_grad():
        pilot = flow.sample((ROWS,), theta_tuple, generator=gen(SEED + 4))
    cut = float(pilot[:, 0].median())
    rounds = []

    def condition(x):
        rounds.append(1)
        return x[..., 0] > cut

    def rejection():
        return dt.sample_with_rejection(flow, REJECTION_SAMPLES, condition,
                                        theta_tuple, generator=gen(SEED + 5))

    s, counts = counted(rejection)
    if not launches_are(counts, chain_apply=len(rounds)) or not rounds:
        fail(f"sample_with_rejection: launches {counts} for {len(rounds)} "
             "rounds, expected one chain_apply a round")
    launches["sample_with_rejection"] = counts["chain_apply"]
    n_rounds = len(rounds)
    if s.shape != (REJECTION_SAMPLES, D) or not bool((s[:, 0] > cut).all()):
        fail("sample_with_rejection: a row fails the condition")
    rej_ms = time_ms(rejection, warmup=1, runs=5)
    report["sample_with_rejection"] = dict(
        samples=REJECTION_SAMPLES, rounds=n_rounds, ms=rej_ms,
        draws_per_s=REJECTION_SAMPLES / (rej_ms * 1e-3))

    # SBC with θ_true from the flow itself: the ranks are uniform
    sims, n_draws = SBC["sims"], SBC["draws"]
    x_obs = (torch.as_tensor(meta.theta_min) + torch.as_tensor(
        meta.theta_max - meta.theta_min) * torch.rand(
            (sims, N_COND), generator=torch.Generator().manual_seed(SEED))
    ).to(device)
    with torch.no_grad():
        theta_true = flow.sample((sims,), x_obs, generator=gen(SEED + 6))

    def ranks():
        return dt.sbc_ranks(flow, theta_true, x_obs, n_draws=n_draws,
                            generator=gen(SEED + 7))

    r, counts = counted(ranks)
    if not launches_are(counts, chain_sample=1):
        fail(f"sbc_ranks: launches {counts}, expected one chain_sample")
    launches["sbc_ranks"] = counts["chain_sample"]
    ks = inf.sbc_uniformity(r, n_draws)
    # the 1 % level of the largest of the 32 parameters' statistics (0.129;
    # 1.63/√256 = 0.102 is one parameter's, which the largest of 32 passes
    # with probability 0.8 only)
    gate = sbc_null_quantile(sims, n_draws, D)
    if r.shape != (sims, D) or ks >= gate:
        fail(f"sbc_ranks: uniformity {ks} >= {gate}, the 1 % level of a "
             "calibrated posterior")
    sbc_ms = time_ms(ranks, warmup=1, runs=5)
    report["sbc_ranks"] = dict(
        sims=sims, draws=n_draws, uniformity=ks, uniformity_gate=gate,
        one_parameter_level=1.63 / np.sqrt(sims), ms=sbc_ms,
        draws_per_s=sims * n_draws / (sbc_ms * 1e-3))
    say(phase="inference_main_path", card=card,
        config=f"d {D}, n {N_COND}: {N_BLOCKS} RealNVP blocks hidden "
               f"{HIDDEN} + normalization, {chains} chains",
        launches=launches, **report)
    return launches, report


def snpe_problem(device, seed):
    """The conjugate-Gaussian posterior problem at BASELINE's widths: its
    simulator (recording what it simulates), prior and a fresh posterior
    flow over θ ∈ R⁵ given x ∈ R⁵ — three RealNVP couplings of hidden 16 and
    a normalization layer, x bounds ±5."""
    d, sigma = SNPE["d"], SNPE["sigma"]
    sim_rng = np.random.default_rng(seed)
    seen = []

    def simulator(theta):
        x = theta + sigma * sim_rng.normal(size=theta.shape)
        seen.append((np.asarray(theta, np.float32),
                     np.asarray(x, np.float32)))
        return x

    def prior_sample(rng, n):
        return rng.normal(size=(n, d))

    def prior_log_prob(theta):
        t_ = np.asarray(theta, np.float64)
        return -0.5 * (t_ * t_).sum(-1) - 0.5 * d * np.log(2 * np.pi)

    def flow():
        g = torch.Generator().manual_seed(seed)
        kw = dict(n=d, hidden_dim_s=16, hidden_dim_t=16, generator=g,
                  device=device)
        pilot = np.random.default_rng(seed + 1).normal(size=(1000, d))
        return dt.Flow(dt.flow_chain(
            dt.coupling_layer(d, [0, 1, 2], **kw),
            dt.coupling_layer(d, [2, 3, 4], **kw),
            dt.coupling_layer(d, [4, 0, 1], **kw),
            dt.normalization_layer(pilot.astype(np.float32), -1.0, 1.0,
                                   device=device)),
            dt.MetaData("snpe", d, d, -5.0 * np.ones(d, np.float32),
                        5.0 * np.ones(d, np.float32)), device=device)

    return simulator, prior_sample, prior_log_prob, flow, seen


def posterior_errors(flow, device, seed):
    """Per-coordinate |mean − analytic| and |std − analytic| of 2^16 draws
    at X_OBS."""
    s2 = SNPE["sigma"] ** 2
    with torch.no_grad():
        draws = flow.sample((SNPE["draws"],), tuple(float(v) for v in X_OBS),
                            generator=torch.Generator(device=device)
                            .manual_seed(seed)).double()
    if not bool(torch.isfinite(draws).all()):
        fail("posterior draws are not finite")
    mean_err = (draws.mean(0).cpu().numpy() - X_OBS / (1 + s2))
    std_err = draws.std(0).cpu().numpy() - np.sqrt(s2 / (1 + s2))
    return np.abs(mean_err), np.abs(std_err)


def drive_snpe(device, tmp, card):
    """SNPE at BASELINE's widths on the conjugate-Gaussian posterior:

    - fit_posterior_rounds("snpe_b"), 3 rounds × 1,000 simulations, 50
      epochs, batch 64: flow.trained_path "fused" (resident), one train_run
      launch a round, rounds 2–3 one chain_sample (the proposals) and one
      chain_apply (their log q) each, nothing else; the std of 2^16 draws
      within 0.1 of the analytic posterior per coordinate, the mean within
      0.3 (SNPE);
    - fit_posterior_apt on the same 3,000 simulations (per-layer autograd,
      no kernel): within 0.15;
    - run_smc, d 32, 2^16 particles, 20 steps, to a Gaussian target: the
      weighted mean and variance within 0.05 per coordinate;
    - systematic_resample_sharded on a one-rank NCCL mesh at 2^20 × 32
      against systematic_resample: the same rows; both timed."""
    import torch.distributed as dist

    simulator, prior_sample, prior_log_prob, make_flow, seen = snpe_problem(
        device, SEED + 71)
    flow = make_flow()
    marks = []

    def timed_simulator(theta):
        x = simulator(theta)
        marks.append(time.perf_counter())
        return x

    reset_counts()
    t0 = time.perf_counter()
    flow, history = dt.fit_posterior_rounds(
        flow, timed_simulator, prior_sample, prior_log_prob, X_OBS,
        n_rounds=SNPE["rounds"], n_sims_per_round=SNPE["sims"],
        epochs=SNPE["epochs"], batchsize=SNPE["batch"],
        generator=torch.Generator(device=device).manual_seed(SEED + 72),
        rng=np.random.default_rng(SEED + 73))
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = read_counts()
    if flow.trained_path != "fused" or flow.fused_kernel_mode != "resident":
        fail(f"fit_posterior_rounds: trained on {flow.trained_path} "
             f"({flow.fused_kernel_mode}): {flow.fused_decline_reason}")
    later = SNPE["rounds"] - 1
    if not launches_are(counts, train_run=SNPE["rounds"],
                        chain_sample=later, chain_apply=later):
        fail(f"fit_posterior_rounds: launches {counts}, expected "
             f"{SNPE['rounds']} train_run, {later} chain_sample and "
             f"{later} chain_apply")
    mean_err, std_err = posterior_errors(flow, device, SEED + 74)
    if mean_err.max() > SNPE["mean_gate"] or std_err.max() > SNPE["std_gate"]:
        fail(f"SNPE-B posterior: mean errors {mean_err}, std errors "
             f"{std_err} (gates {SNPE['mean_gate']} / {SNPE['std_gate']})")
    # a round: its fit, then the next round's proposal (from the end of one
    # simulation to the end of the next)
    ends = marks[1:] + [end]
    round_s = [b - a for a, b in zip(marks, ends)]
    snpe = dict(launches=counts, history=history, seconds=end - t0,
                seconds_by_round=round_s,
                mean_abs_err=mean_err.tolist(), std_abs_err=std_err.tolist(),
                stats_within_0_1=int((mean_err <= 0.1).sum()
                                     + (std_err <= 0.1).sum()))

    theta_all = np.concatenate([s[0] for s in seen])
    x_all = np.concatenate([s[1] for s in seen])
    apt_flow = make_flow()
    reset_counts()
    t0 = time.perf_counter()
    dt.fit_posterior_apt(apt_flow, theta_all, x_all, prior_log_prob,
                         n_atoms=SNPE["atoms"], epochs=SNPE["apt_epochs"],
                         batchsize=SNPE["batch"],
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED + 75))
    torch.cuda.synchronize()
    apt_s = time.perf_counter() - t0
    if not launches_are(read_counts()):
        fail(f"fit_posterior_apt launched kernels: {read_counts()}")
    a_mean, a_std = posterior_errors(apt_flow, device, SEED + 76)
    if max(a_mean.max(), a_std.max()) > SNPE["apt_gate"]:
        fail(f"APT posterior: mean errors {a_mean}, std errors {a_std} "
             f"(gate {SNPE['apt_gate']})")
    apt = dict(seconds=apt_s, epochs=SNPE["apt_epochs"],
               ms_per_step=1e3 * apt_s / (SNPE["apt_epochs"] * (
                   len(theta_all) // SNPE["batch"])),
               final_atomic_loss=apt_flow.train_loss[-1],
               mean_abs_err=a_mean.tolist(), std_abs_err=a_std.tolist())

    # SMC to N(mu, diag(scale²)) from N(0, I)
    d = SMC["d"]
    mu = np.linspace(-0.5, 0.5, d).astype(np.float32)
    scale = np.linspace(0.8, 1.2, d).astype(np.float32)
    mu_t, sc_t = torch.as_tensor(mu).to(device), torch.as_tensor(scale).to(
        device)

    def log_p(x):
        u = (x - mu_t) / sc_t
        return -0.5 * (u * u).sum(-1)

    reset_counts()
    t0 = time.perf_counter()
    particles, log_w, diag = dt.run_smc(
        log_p, d, SMC["particles"], n_steps=SMC["steps"],
        mh_step_size=SMC["mh_step"], n_mh=SMC["n_mh"], generator=torch.Generator(device=device).manual_seed(SEED + 77),
        device=device)
    torch.cuda.synchronize()
    smc_s = time.perf_counter() - t0
    w = torch.softmax(log_w.double(), 0)[:, None]
    p64 = particles.double()
    est_mean = (w * p64).sum(0)
    est_var = (w * (p64 - est_mean) ** 2).sum(0)
    m_err = float((est_mean.cpu() - torch.as_tensor(mu)).abs().max())
    v_err = float((est_var.cpu() - torch.as_tensor(scale) ** 2).abs().max())
    if not bool(torch.isfinite(particles).all()) or \
            max(m_err, v_err) > SMC["gate"]:
        fail(f"run_smc: weighted mean off by {m_err}, variance by {v_err}")
    smc = dict(seconds=smc_s, ms_per_step=1e3 * smc_s / SMC["steps"],
               mean_abs_err=m_err, var_abs_err=v_err,
               ess_last=float(diag["ess"][-1]),
               resampled_steps=int((diag["ess"] < 0.5 * SMC["particles"])
                                   .sum()),
               mh_accept_mean=float(diag["mh_accept"].mean()),
               launches=read_counts())

    # the ring resampler on one NCCL rank against the single-device one
    g = torch.Generator().manual_seed(SEED + 78)
    n, d = RESAMPLE["rows"], RESAMPLE["d"]
    lw = (torch.randn(n, generator=g) * 2.0).to(device)
    parts = torch.randn((n, d), generator=g).to(device)
    u0 = float(torch.rand((), generator=g))
    dt.distributed_init(f"file://{tmp}/resample", 1, 0, backend="nccl")
    try:
        mesh = dt.make_mesh()
        if mesh.group is None or mesh.size != 1:
            fail(f"resample mesh: {mesh}")
        got = dt.systematic_resample_sharded(lw, parts, None, mesh, u0=u0)
        want = parts[inf._systematic_resample(
            lw, torch.tensor(u0, device=device))]
        if not torch.equal(got, want):
            fail("systematic_resample_sharded on one rank: rows differ from "
                 "systematic_resample")
        sharded_ms = time_ms(lambda: dt.systematic_resample_sharded(
            lw, parts, None, mesh, u0=u0))
    finally:
        dist.destroy_process_group()
    single_ms = time_ms(lambda: parts[dt.systematic_resample(
        lw, torch.Generator(device=device).manual_seed(1))])
    resample = dict(rows=n, d=d, same_rows=True, sharded_one_rank_ms=sharded_ms,
                    single_device_ms=single_ms)
    say(phase="snpe_main_path", card=card,
        config=f"RealNVP, 3 couplings hidden 16 + normalization, theta "
               f"in R^{SNPE['d']} given x in R^{SNPE['d']}, Adam 1e-3, "
               f"batch {SNPE['batch']}",
        snpe_b=snpe, apt=apt, smc=smc, resample=resample)
    return counts, dict(snpe_b=snpe, apt=apt, smc=smc, resample=resample)


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


# -- the plain program's Adam update on the card -----------------------------------

def check_adam_update(device, card):
    """``Adam.update`` (one multi-tensor launch per operation over all the
    leaves) and the parameter step ``_foreach_add_`` against the same
    arithmetic written out leaf by leaf, on the flagship chain's leaves for
    three steps of random gradients: the same bits."""
    from densityflows_tpu_torch.train import _bias_corrections

    rng = np.random.default_rng(SEED + 61)
    leaves = ft.trainable_leaves(wide_chain(False, rng, device))
    opt = dt.Adam(1e-3)
    state = opt.init(leaves)
    ref_p = [p.detach().clone() for p in leaves]
    ref_mu = [torch.zeros_like(p) for p in leaves]
    ref_nu = [torch.zeros_like(p) for p in leaves]
    params = [p.detach().clone() for p in leaves]
    for step in range(1, 4):
        grads = [put(rng.normal(size=p.shape) * 10.0 ** -step, device)
                 for p in leaves]
        updates, state = opt.update(grads, state, params)
        torch._foreach_add_(params, list(updates))
        bc1, bc2 = _bias_corrections(opt.b1, opt.b2, step)
        ref_mu = [opt.b1 * m + (1.0 - opt.b1) * g
                  for m, g in zip(ref_mu, grads)]
        ref_nu = [opt.b2 * v + (1.0 - opt.b2) * (g * g)
                  for v, g in zip(ref_nu, grads)]
        for p, m, v in zip(ref_p, ref_mu, ref_nu):
            p.add_(-opt.learning_rate * ((m / bc1)
                                         / (torch.sqrt(v / bc2) + opt.eps)))
    for name, got, want in (("parameters", params, ref_p),
                            ("first moments", state.mu, ref_mu),
                            ("second moments", state.nu, ref_nu)):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"Adam.update on the card: the {name} differ from the "
                 "leaf-by-leaf update")
    report = dict(card=card, leaves=len(leaves), steps=3,
                  elements=sum(p.numel() for p in leaves),
                  foreach_vs_per_leaf="bit for bit")
    say(phase="adam_update", **report)
    return report


# -- the deep ensemble: train_run's member axis ------------------------------------

ENSEMBLE_K_SMALL = 3
ENSEMBLE_K = 5
ENSEMBLE_SWEEP = (1, 5, 32, 132, 264)
ENSEMBLE_EAGER_EPOCHS = 10


def run_tensors(out):
    """Every tensor of a run_fused_train result, in order."""
    ts = list(out[0]) + list(out[1]) + list(out[2]) + [out[3], out[4]]
    if out[5] is not None:
        ts += list(out[5])
    if out[6] is not None:
        ts.append(out[6])
    return ts


def runs_bit_equal(a, b):
    return all(torch.equal(torch.nan_to_num(u), torch.nan_to_num(v))
               and torch.equal(torch.isnan(u), torch.isnan(v))
               for u, v in zip(run_tensors(a), run_tensors(b)))


def members_of(case, rng, k):
    """K members of one small case: its folded tensors scaled per member
    (the fold's zeros stay zero), zero moments, a batch order each."""
    tps = [[p * (1.0 + 0.1 * i) for p in case.tparams] for i in range(k)]
    epochs = case.perms.shape[0]
    perms = [np.stack([rng.permutation(case.n_rows) for _ in range(epochs)])
             for _ in range(k)]
    return tps, perms


def check_members(case, rng, what, nan_histories=False, **kw):
    """One launch of K blocks against K one-member launches (bit for bit)
    and against the plain version per member (TRAIN_TOL; with
    ``nan_histories``, NaN rows in the splits: the parameters, moments and
    skips, and NaN histories on both sides)."""
    k = ENSEMBLE_K_SMALL
    tps, perms = members_of(case, rng, k)
    zeros = [case.zeros] * k
    got = tk.run_fused_train_members(
        case.plan, tps, case.masks, case.slots, case.cparams, zeros, zeros,
        *case.arrays, perms, batchsize=case.batchsize, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(k):
        state = (tps[i], case.zeros, case.zeros)
        one = case.run(tk.run_fused_train, perms=perms[i], state=state, **kw)
        if not runs_bit_equal(got[i], one):
            fail(f"train_run members ({what}): member {i} of one launch "
                 "differs from its own launch")
        want = case.run(tk.fused_train_plain, perms=perms[i], state=state,
                        **kw)
        if not nan_histories:
            err = max(err, require_runs_close(
                got[i], want, f"train_run members ({what}) member {i}",
                TRAIN_TOL))
            continue
        if got[i][6].tolist() != want[6].tolist():
            fail(f"train_run members ({what}) member {i}: skips "
                 f"{got[i][6].tolist()} vs plain {want[6].tolist()}")
        for j in (0, 1, 2):
            for u, v in zip(got[i][j], want[j]):
                err = max(err, require_close(
                    u, v, f"train_run members ({what}) member {i}",
                    **TRAIN_TOL))
        if not bool(torch.isnan(got[i][3]).all()):
            fail(f"train_run members ({what}): the full-split NLL over NaN "
                 "rows must be NaN")
    return err, got


def check_ensemble_small(rng, device):
    """K = 3 members of check_train_small's cases in one launch each."""
    data, x = small_train_data(rng, 1)
    errs = {}
    for name, layers in small_train_chains(data, x, device).items():
        errs[name] = check_members(TrainCase(layers, data, device, rng), rng,
                                   name)[0]
    ref = small_train_chains(data, x, device)["reference"]
    case = TrainCase(ref, data, device, rng, epochs=5)
    errs["weighted_track_best"] = check_members(
        case, rng, "weighted + track_best", w=case.w, w_valid=case.wv,
        track_best=True, lr=3e-3, b1=0.85)[0]
    arrays = list(case.arrays)
    arrays[0] = arrays[0].clone()
    arrays[0][[5, 40, 77], 1] = float("nan")
    case.arrays = tuple(arrays)
    errs["guard_nan_rows"], got = check_members(
        case, rng, "guard, NaN rows", nan_histories=True,
        guard_nonfinite=True)
    skipped = [int(g[6].sum()) for g in got]
    if min(skipped) == 0:
        fail(f"train_run members guard: skips {skipped}")
    return errs, skipped


def baseline_factory(data, dat, device):
    def factory(generator):
        kw = dict(hidden_dim_s=16, hidden_dim_t=16, generator=generator,
                  device=device)
        return dt.flow_chain(
            dt.coupling_layer(data, [0, 1, 2], **kw),
            dt.coupling_layer(data, [2, 3, 4], **kw),
            dt.coupling_layer(data, [4, 0, 1], **kw),
            dt.normalization_layer(dat["x"], -1.0, 1.0, device=device))
    return factory


def train_run_bound(chain, n_train, n_valid, d, n_cond, epochs, packed):
    """The least time of one ``train_run`` member's run: every product it
    needs — per training row the forward and two backward products per
    layer, per evaluated row the forward — at the layers' own shapes, over
    the f32 rate; against every input read once and every output written
    once. Returns (ms, bound_by, flops, bytes)."""
    fwd = needed_flops_per_row(chain)
    flops = epochs * (3 * n_train + (n_train + n_valid)) * fwd
    n_pad = -(-n_train // TRAIN_BATCH) * TRAIN_BATCH
    nbytes = 4 * ((n_train + n_valid) * (d + n_cond) + epochs * n_pad
                  + 7 * packed.n_params + packed.flat_consts.numel()
                  + packed.prog.numel() + 3 * epochs)
    ms, by = bound_ms(flops, nbytes)
    return ms, by, flops, nbytes


def ensemble_moment_gate(ens, theta_tuple, rows):
    """moment_gate for the mixture: its draws through ``chain_apply``
    against the per-layer path's, over three seeds, the same gates."""
    zs = []
    for seed in (11, 21, 31):
        s_k = ens.sample((rows,), theta_tuple,
                         generator=torch.Generator().manual_seed(seed))
        with kernel_policy(False):
            s_p = ens.sample((rows,), theta_tuple,
                             generator=torch.Generator().manual_seed(seed + 1))
        s_k, s_p = s_k.double(), s_p.double()
        if not bool(torch.isfinite(s_k).all()):
            fail("ensemble sample: non-finite draws")
        se = s_p.std(0) / np.sqrt(rows)
        z = float(((s_k.mean(0) - s_p.mean(0)).abs() / (np.sqrt(2) * se)).max())
        ratio = s_k.std(0) / s_p.std(0)
        if z > 5.0 or float((ratio - 1).abs().max()) > 0.05:
            fail(f"ensemble sample moments diverged (seed {seed}): z={z}, "
                 f"std ratios {ratio.tolist()}")
        zs.append(z)
    if statistics.median(zs) > 4.0:
        fail(f"ensemble sample shows a persistent moment bias: z {zs}")
    return zs


def drive_ensemble(device, tmp, card):
    """``train_ensemble`` at BASELINE x K = 5: one ``train_run`` launch of 5
    blocks, each member equal to its own one-member launch; then the one
    launch against K launches and the plain program (eager and vmapped),
    the member sweep, the mixture's log_prob / sample at 2^18 rows and a
    checkpoint round trip."""
    from densityflows_tpu_torch import ensemble as ens_mod
    from densityflows_tpu_torch.train import _chunk_generator, _chunk_seed

    data, dat = baseline_data()
    factory = baseline_factory(data, dat, device)
    k, epochs = ENSEMBLE_K, TRAIN_EPOCHS
    t0 = time.time()
    ens, counts = counted(lambda: dt.train_ensemble(
        factory, data, n_members=k, epochs=epochs, batchsize=TRAIN_BATCH,
        generator=torch.Generator().manual_seed(SEED), verbose=False,
        device=device))
    seconds = time.time() - t0
    if not launches_are(counts, train_run=1):
        fail(f"train_ensemble launches {counts}, expected one train_run")
    if ens.trained_path != ["fused"] * k or any(ens.fused_decline_reason):
        fail(f"train_ensemble did not take the kernel: {ens.trained_path}, "
             f"{ens.fused_decline_reason}")
    tl, vl = np.asarray(ens.train_loss), np.asarray(ens.valid_loss)
    if tl.shape != (epochs, k) or not np.isfinite(tl).all() \
            or not np.isfinite(vl).all():
        fail("train_ensemble: histories are not (50, 5) finite entries")
    # every member learns; the members' median meets the single flow's bar
    # (their inits differ: one member alone may end above it)
    if not (vl[-1] < vl[0]).all() or np.median(vl[-1]) > 3.3:
        fail(f"train_ensemble: valid NLL {vl[0]} -> {vl[-1]}, expected "
             "every member to decrease and their median to end at most 3.3")

    # the members as train_ensemble built them: their generators, their
    # batch orders
    g = torch.Generator().manual_seed(SEED)
    init_seed, train_seed = _chunk_seed(g), _chunk_seed(g)
    members = [factory(_chunk_generator(init_seed, i)) for i in range(k)]
    flows = [dt.Flow(m, data, device=device) for m in members]
    n_train = len(data.partition.training)
    n_valid = len(data.partition.validation)
    perms = [ft.draw_epoch_perms(_chunk_generator(train_seed, i), epochs,
                                 n_train) for i in range(k)]
    folds, packed = ens_mod._kernel_members(flows, TRAIN_BATCH)
    xt, tht = data.normalized_training_data(flows[0].metadata)
    xv, thv = data.normalized_validation_data(flows[0].metadata)
    arrays = (put(xt, device), put(tht, device), put(xv, device),
              put(thv, device))
    plan, _tc, _tp, masks, slots, cparams = folds[0][:6]
    tps = [f[2] for f in folds]
    zeros = [[torch.zeros_like(p) for p in tps[0]]] * k
    head = (plan, tps[0], masks, slots, cparams, zeros[0], zeros[0])
    kw = dict(batchsize=TRAIN_BATCH, packed=packed)
    for i in range(k):
        one = tk.run_fused_train(plan, tps[i], masks, slots, cparams,
                                 zeros[0], zeros[0], *arrays, perms[i], **kw)
        got = folds[i][7](one[0])
        if not (np.array_equal(one[3].cpu().numpy(), tl[:, i]
                               .astype(np.float32))
                and np.array_equal(one[4].cpu().numpy(),
                                   vl[:, i].astype(np.float32))
                and all(torch.equal(a, b.detach()) for a, b in zip(
                    got, ft.trainable_leaves(ens.model[i])))):
            fail(f"train_ensemble member {i} differs from its own one-member "
                 "launch")

    # the plain program on the same members and batch orders, member after
    # member (eager) and vmapped over the members (the route of an ensemble
    # the kernel declines): their histories against the kernel's first
    # epochs, and their times over ENSEMBLE_EAGER_EPOCHS epochs
    e_eager = ENSEMBLE_EAGER_EPOCHS
    plain_ms, hist_early = {}, {}
    for name, program in (("eager", ens_mod._train_members_plain),
                          ("vmapped", ens_mod._train_members_vmapped)):
        plain_flows = [dt.Flow(factory(_chunk_generator(init_seed, i)), data,
                               device=device) for i in range(k)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tls_p, vls_p = program(
            plain_flows, dt.Adam(), arrays,
            np.stack([p[:e_eager] for p in perms]), TRAIN_BATCH, e_eager,
            True)
        torch.cuda.synchronize()
        plain_ms[name] = 1e3 * (time.perf_counter() - t0)
        hist_early[name] = float(max(np.abs(tls_p[:, :3] - tl[:3].T).max(),
                                     np.abs(vls_p[:, :3] - vl[:3].T).max()))
        if hist_early[name] > 1e-4:
            fail(f"train_ensemble against the {name} plain program: first "
                 f"3 epochs differ by {hist_early[name]}")

    # times: one launch of K blocks, K one-member launches in a row
    one_ms = time_ms(lambda: tk.run_fused_train_members(
        plan, tps, masks, slots, cparams, zeros, zeros, *arrays, perms,
        **kw), warmup=1, runs=5)
    k_launch_ms = time_ms(lambda: [tk.run_fused_train(
        plan, tps[i], masks, slots, cparams, zeros[0], zeros[0], *arrays,
        perms[i], **kw) for i in range(k)], warmup=1, runs=5)
    single_ms = time_ms(lambda: tk.run_fused_train(
        *head, *arrays, perms[0], **kw), warmup=1, runs=5)
    sweep = {}
    for kk in ENSEMBLE_SWEEP:
        tp_k = [tps[i % k] for i in range(kk)]
        pm_k = [perms[i % k] for i in range(kk)]
        z_k = zeros[:1] * kk
        ms = time_ms(lambda: tk.run_fused_train_members(
            plan, tp_k, masks, slots, cparams, z_k, z_k, *arrays, pm_k,
            **kw), warmup=1, runs=2)
        sweep[kk] = dict(ms=ms, ms_per_member=ms / kk)
    b_ms, b_by, flops, nbytes = train_run_bound(
        members[0], n_train, n_valid, xt.shape[1], tht.shape[1], epochs,
        packed)

    # the mixture at 2^18 rows: K chain_apply launches per call
    rng = np.random.default_rng(SEED + 41)
    idx = rng.integers(0, dat["x"].shape[0], size=ROWS)
    x = put(dat["x"][idx] + 0.05 * rng.normal(size=(ROWS, 5)), device)
    th = put(dat["theta"][idx], device)
    lpm, c_members = counted(lambda: ens.log_prob_members(x, th))
    lp, c_lp = counted(lambda: ens.log_prob(x, th))
    smp, c_sample = counted(lambda: ens.sample(
        (ROWS,), (-1.0,), generator=torch.Generator().manual_seed(SEED)))
    for what, c in (("log_prob_members", c_members), ("log_prob", c_lp),
                    ("sample", c_sample)):
        if not launches_are(c, chain_apply=k):
            fail(f"ensemble {what}: launches {c}, expected {k} chain_apply")
    if lpm.shape != (k, ROWS) or smp.shape != (ROWS, 5) \
            or not bool(torch.isfinite(lp).all()):
        fail("ensemble: wrong shapes or non-finite log_prob")
    with kernel_policy(False), torch.no_grad():
        lp_plain = ens.log_prob(x, th)
        lpm_plain = ens.log_prob_members(x, th)
    err_mix = require_close(lp, lp_plain, "ensemble log_prob vs per-layer "
                            "path", 1e-4, 1e-4)
    err_members = require_close(lpm, lpm_plain, "ensemble log_prob_members "
                                "vs per-layer path", 1e-4, 1e-4)
    with torch.no_grad():
        zs = ensemble_moment_gate(ens, (-1.0,), ROWS)
    lp_ms = time_ms(lambda: ens.log_prob(x, th), warmup=1, runs=5)
    sample_ms = time_ms(lambda: ens.sample(
        (ROWS,), (-1.0,), generator=torch.Generator().manual_seed(1)),
        warmup=1, runs=5)

    # the checkpoint on the card
    dt.save_ensemble(f"{tmp}/ensemble", ens)
    back = dt.load_ensemble(f"{tmp}/ensemble", device=device)
    with torch.no_grad():
        if not torch.equal(back.log_prob(x[:4096], th[:4096]),
                           ens.log_prob(x[:4096], th[:4096])) \
                or np.asarray(back.train_loss).shape != (epochs, k):
            fail("save_ensemble -> load_ensemble did not restore the "
                 "ensemble")
    report = dict(
        card=card, members=k, epochs=epochs, batchsize=TRAIN_BATCH,
        train_run_launches=counts["train_run"], train_ensemble_s=seconds,
        final_valid_nll=vl[-1].tolist(),
        members_equal_own_launch="bit for bit",
        first_3_epochs_vs_plain_program=hist_early,
        one_launch_ms=one_ms, k_launches_ms=k_launch_ms,
        one_member_launch_ms=single_ms, shared_bytes=packed.shared_bytes,
        threads=tk._block_threads(packed),
        plain_program_epochs=e_eager, eager_program_ms=plain_ms["eager"],
        vmapped_program_ms=plain_ms["vmapped"],
        bound_ms_per_member=b_ms, bound_ms_k=k * b_ms, bound_by=b_by,
        sweep=sweep, rows=ROWS, log_prob_ms=lp_ms, sample_ms=sample_ms,
        log_prob_max_abs_err_vs_per_layer=err_mix,
        log_prob_members_max_abs_err_vs_per_layer=err_members,
        chain_apply_launches=dict(log_prob_members=c_members["chain_apply"],
                                  log_prob=c_lp["chain_apply"],
                                  sample=c_sample["chain_apply"]),
        sample_moment_z_by_seed=zs, checkpoint_round_trip="equal")
    say(phase="ensemble_main_path", **report)
    return report


# -- precision and memory: mixed precision, remat, bf16-stored conditioners -----

# train(mixed_precision=True) against the f32 plain program: the JAX
# package's own gates for its bf16 loss against its f32 loss
# (tests/test_mixed_precision.py): each step's loss within 0.05 (1 + |L|),
# the final NLL within 0.15 (1 + |L|)
MP_STEP_GATE, MP_FINAL_GATE = 0.05, 0.15
PRECISION_BATCH, PRECISION_ROWS, PRECISION_STEPS = 1024, 36409, 32
REMAT_ROWS = 1 << 16


def drive_precision(device, card):
    """At the flagship wide chain: 32 steps of train(mixed_precision=True)
    against the f32 plain program, remat's gradients and peak memory, a
    cast_conditioners chain through chain_apply / chain_sample."""
    rng = np.random.default_rng(SEED + 51)
    chain0 = wide_chain(False, rng, device)
    x_np = (rng.normal(size=(PRECISION_ROWS, D)) * 0.5).astype(np.float32)
    th_np = rng.uniform(size=(PRECISION_ROWS, N_COND)).astype(np.float32)
    data = dt.DataArrays.make(x_np, th_np, rng=0)
    n_train = len(data.partition.training)
    if -(-n_train // PRECISION_BATCH) != PRECISION_STEPS:
        fail(f"precision: {n_train} training rows are not "
             f"{PRECISION_STEPS} batches")
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED), 1,
                                n_train)
    flows = {}
    for name, kw in (("mixed_precision", dict(mixed_precision=True)),
                     ("remat", dict(remat=True)),
                     ("f32", dict(fused_kernel=False))):
        f = dt.Flow(copy.deepcopy(chain0), data, device=device)
        t0 = time.time()
        state = dt.train(f, data, epochs=1, batchsize=PRECISION_BATCH,
                         verbose=False, _epoch_perms=perms, **kw)
        torch.cuda.synchronize()
        flows[name] = (f, state, time.time() - t0)
        if name != "f32" and (f.trained_path != "torch"
                              or name not in str(f.fused_decline_reason)):
            fail(f"train({name}=True): path {f.trained_path}, reason "
                 f"{f.fused_decline_reason}")
    f_mp, s_mp, mp_s = flows["mixed_precision"]
    f_32, s_32, f32_s = flows["f32"]
    f_rm = flows["remat"][0]
    # remat changes no arithmetic: the same histories as the f32 program
    remat_hist = max(abs(a - b) for a, b in zip(
        f_rm.train_loss + f_rm.valid_loss, f_32.train_loss + f_32.valid_loss))
    if not remat_hist <= 1e-4:
        fail(f"train(remat=True) differs from the plain program by "
             f"{remat_hist}")
    for t in ft.trainable_leaves(f_mp.model) + s_mp.mu + s_mp.nu:
        if t.dtype != torch.float32:
            fail(f"mixed precision: a parameter or moment is {t.dtype}")
    final_gap = max(abs(a - b) / (1 + abs(b)) for a, b in zip(
        f_mp.train_loss + f_mp.valid_loss, f_32.train_loss + f_32.valid_loss))
    if not final_gap < MP_FINAL_GATE:
        fail(f"mixed precision: final NLL gap {final_gap} (gate "
             f"{MP_FINAL_GATE} (1 + |L|))")

    # each step's loss: make_train_step(mixed_precision=True) against the
    # f32 step on the same batches
    xt, tht = data.normalized_training_data(f_32.metadata)
    xt, tht = put(xt, device), put(tht, device)
    step_gap = 0.0
    losses = {}
    for mp in (True, False):
        model = copy.deepcopy(chain0)
        opt = dt.adam(1e-3)
        step = dt.make_train_step(opt, mixed_precision=mp)
        state = opt.init(ft.trainable_leaves(model))
        out = []
        for b in range(PRECISION_STEPS):
            rows = torch.as_tensor(
                perms[0][b * PRECISION_BATCH:(b + 1) * PRECISION_BATCH],
                device=device)
            m = torch.ones(rows.shape[0], device=device)
            model, state, loss = step(model, state, dt.StandardNormal(D),
                                      xt[rows], tht[rows], m)
            out.append(float(loss))
        losses[mp] = out
    step_gap = max(abs(a - b) / (1 + abs(b))
                   for a, b in zip(losses[True], losses[False]))
    if not step_gap < MP_STEP_GATE:
        fail(f"mixed precision: a step's loss gap {step_gap} (gate "
             f"{MP_STEP_GATE} (1 + |L|))")
    # bfloat16 products ran: the first step (the f32 step's weights and
    # rows) differs from the f32 loss and equals, at 1e-6 (1 + |L|), the
    # loss of the explicitly cast chain (the same operations)
    rows0 = torch.as_tensor(perms[0][:PRECISION_BATCH], device=device)
    with torch.no_grad():
        cast_loss = float(dt.masked_nll_loss(
            dt.cast_conditioners(chain0), dt.StandardNormal(D), xt[rows0],
            tht[rows0], torch.ones(PRECISION_BATCH, device=device)))
    first_bf16, first_f32 = losses[True][0], losses[False][0]
    if first_bf16 == first_f32 or \
            abs(first_bf16 - cast_loss) > 1e-6 * (1 + abs(cast_loss)):
        fail(f"mixed precision: the first step's loss {first_bf16} is not "
             f"the bfloat16 chain's {cast_loss} (float32: {first_f32})")

    # remat: the same gradients, less memory, at 2^16 rows
    xr = put(rng.normal(size=(REMAT_ROWS, D)) * 0.5, device)
    thr = put(rng.uniform(size=(REMAT_ROWS, N_COND)), device)
    mask = torch.ones(REMAT_ROWS, device=device)
    grads, peak = {}, {}
    for remat in (False, True):
        model = copy.deepcopy(chain0)
        leaves = ft.trainable_leaves(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        with torch.enable_grad():
            loss = dt.masked_nll_loss(model, dt.StandardNormal(D), xr, thr,
                                      mask, remat=remat)
            grads[remat] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() - base_mem
        del loss, model, leaves
    remat_err = max(require_close(a, b, "remat gradient vs plain", 1e-4,
                                  1e-4)
                    for a, b in zip(grads[True], grads[False]))
    del grads

    # bf16-stored conditioners through the chain kernels: the plain
    # per-layer path on the same bf16-rounded weights (held in f32)
    meta = dt.MetaData("bf16", D, N_COND, np.zeros(N_COND, np.float32),
                       np.ones(N_COND, np.float32))
    cast = dt.cast_conditioners(chain0)
    flow_c = dt.Flow(cast, meta, device=device)
    ref = dt.Flow(dt.cast_conditioners(cast, torch.float32), meta,
                  device=device)
    x = put(rng.normal(size=(ROWS, D)) * 0.5, device)
    th = put(rng.uniform(size=(ROWS, N_COND)), device)
    lp_c, c_lp = counted(lambda: flow_c.log_prob(x, th))
    theta_tuple = tuple([0.5] * N_COND)
    s_c, c_s = counted(lambda: flow_c.sample(
        (ROWS,), theta_tuple, generator=torch.Generator().manual_seed(SEED)))
    if not launches_are(c_lp, chain_apply=1) \
            or not launches_are(c_s, chain_sample=1):
        fail(f"bf16-stored chain: launches {c_lp} / {c_s}, expected one "
             "chain_apply / one chain_sample")
    if not bool(torch.isfinite(s_c).all()):
        fail("bf16-stored chain: non-finite draws")
    with kernel_policy(False), torch.no_grad():
        lp_ref = ref.log_prob(x, th)
    # |log p| is O(50) here, as in check_main_path
    bf16_err = require_close(lp_c, lp_ref, "bf16-stored chain log_prob vs "
                             "per-layer path on the rounded weights", 1e-4,
                             1e-3)
    report = dict(
        card=card, config="d32 n8 4 blocks h256", batch=PRECISION_BATCH,
        steps=PRECISION_STEPS,
        mixed_precision_trained_path=f_mp.trained_path,
        mixed_precision_decline=f_mp.fused_decline_reason,
        remat_decline=f_rm.fused_decline_reason,
        remat_train_history_max_abs_err=remat_hist,
        mixed_precision_s=mp_s, f32_program_s=f32_s,
        final_nll_gap_rel=final_gap, final_gate=MP_FINAL_GATE,
        step_loss_gap_rel=step_gap, step_gate=MP_STEP_GATE,
        first_step_loss_cast_chain=cast_loss,
        step_losses_bf16_first_last=[losses[True][0], losses[True][-1]],
        step_losses_f32_first_last=[losses[False][0], losses[False][-1]],
        remat_rows=REMAT_ROWS, remat_grad_max_abs_err=remat_err,
        peak_bytes_plain=peak[False], peak_bytes_remat=peak[True],
        bf16_chain_log_prob_max_abs_err=bf16_err,
        bf16_chain_launches=dict(log_prob=c_lp["chain_apply"],
                                 sample=c_s["chain_sample"]),
        allow_bf16_reduced_precision_reduction=bool(
            torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction))
    say(phase="precision_main_path", **report)
    return report


def drive_example_uncertainty(card):
    """The port's uncertainty_and_mcmc example at its own budgets."""
    from densityflows_tpu_torch.examples import uncertainty_and_mcmc

    t0 = time.time()
    out = uncertainty_and_mcmc.main()
    seconds = time.time() - t0
    values = out["final_nll"] + [out["spread_mean"], out["accept_rate"],
                                 out["sbc_ks"]] + out["mcmc_mean"]
    if not np.isfinite(values).all() or not out["accept_rate"] > 0.1:
        fail(f"example uncertainty_and_mcmc: {out}")
    report = dict(card=card, seconds=seconds, **out)
    say(phase="example_uncertainty", **report)
    return report


# -- phase 4j: mesh=, tensor parallelism, the instruments, the A.6 probe ----------

# the 2-D mesh phase: the wide chain trained tensor-parallel against the
# replicated chain in one process: rtol 1e-5 on the losses (the tolerance of
# JAX test_tp_training_matches_replicated); on the gathered parameters after
# the 8 Adam steps 1e-4 on all but at most `past_1e-4` coordinates and 3e-4
# on every one: Adam divides each coordinate's step by its own gradient
# scale, so a coordinate whose gradient is near 0 moves further on rounding
# alone (1.03e-4 on 1 of 1,220,864 coordinates on an H100 with the losses
# equal bit for bit)
TP = {"steps": 8, "batch": 1024, "loss_rtol": 1e-5, "param_atol": 3e-4,
      "past_1e-4": 8}
MESH_TWO_RANKS_TIMEOUT = 420
# the sharded checkpoint: steps taken after the (1, 2) mesh's checkpoint,
# once by the run that goes on and once by the run loaded from it
CKPT_MORE_STEPS = 4
# the inference phase on a one-rank mesh
MESH_MCMC = dict(chains=4096, steps=60, burn_in=10)
MESH_VI = dict(steps=10, particles=1024)
# benchmarks/scaling.py's config (d 16, n 4, two blocks of hidden 64 and a
# normalization layer), per-device batch 1024
SCALING = dict(d=16, n=4, hidden=64, batch=1024, reps=5)
CHUNK_ROWS = (4096, 16384)


def bits_same(a, b):
    return a.shape == b.shape and bool(torch.equal(a.detach(), b.detach()))


def same_or_gated(got, want, what, reason, rtol, atol):
    """``{"bit_equal": True}`` when ``got`` equals ``want`` bit for bit,
    else the difference and its reason, held to ``rtol`` / ``atol``."""
    if bits_same(got, want):
        return {"bit_equal": True}
    err = require_close(got.float(), want.float(), what, rtol, atol)
    return {"bit_equal": False, "max_abs_err": err, "reason": reason,
            "gate": dict(rtol=rtol, atol=atol)}


def drive_mesh_serving(device, mesh, card):
    """``log_prob`` / ``sample`` / ``sample_sweep`` with ``mesh=`` on a
    one-rank NCCL data mesh against the same calls without it (bit for bit,
    one kernel launch each), and the row-offset split of ``chain_sample``:
    a 4-way ceil split of 2^18 + 3 rows, each share one launch with
    ``row_offset = lo``, concatenated, against the one-launch draw (bit for
    bit) and the numpy Philox model at each share's first and last 512
    rows."""
    rng = np.random.default_rng(SEED + 71)
    meta, x, theta, theta_tuple = flagship_inputs(rng, N_COND, ROWS, device,
                                                  "mesh")
    flow = dt.Flow(wide_chain(False, rng, device), meta, device=device)
    thetas = theta[:8].cpu().numpy()
    gen = lambda: torch.Generator().manual_seed(SEED + 5)  # noqa: E731
    calls = {
        "log_prob": (lambda m: flow.log_prob(x, theta, mesh=m),
                     dict(chain_apply=1)),
        "sample": (lambda m: flow.sample((ROWS,), theta_tuple,
                                         generator=gen(), mesh=m),
                   dict(chain_sample=1)),
        "sample_sweep": (lambda m: flow.sample_sweep(
            thetas, ROWS // 8, generator=gen(), mesh=m),
            dict(chain_sample=1)),
    }
    report, launches = {}, {}
    for name, (call, want) in calls.items():
        got, c = counted(lambda: call(mesh))
        if not launches_are(c, **want):
            fail(f"mesh {name}: launches {c}, expected {want}")
        launches[name] = c
        with torch.no_grad():
            if not bits_same(got, call(None)):
                fail(f"{name}(mesh=...) differs from {name}() on one rank")
            report[name] = dict(
                bit_equal=True,
                ms=time_ms(lambda: call(mesh), warmup=1, runs=5),
                ms_no_mesh=time_ms(lambda: call(None), warmup=1, runs=5))

    plan, params = fc._plan_params(flow.model, "fwd")
    total, seed = ROWS + 3, 0x5EED_0FF5E7
    th1 = theta[:1].contiguous()
    one, noise = ck.run_chain_sample(plan, params, total, D, th1, seed=seed,
                                     return_noise=True)
    spans = [dt.host_local_rows(dt.Mesh(None, 4, r), total)
             for r in range(4)]
    ck.reset_launch_counts()
    parts = [ck.run_chain_sample(plan, params, sl.stop - sl.start, D, th1,
                                 seed=seed, row_offset=sl.start,
                                 return_noise=True) for sl in spans]
    torch.cuda.synchronize()
    if ck.launch_counts()["chain_sample"] != 4:
        fail("row-offset split: expected 4 chain_sample launches")
    if not (bits_same(torch.cat([p[0] for p in parts]), one)
            and bits_same(torch.cat([p[1] for p in parts]), noise)):
        fail("chain_sample row-offset split: the shares do not join to the "
             "one-launch draw")
    ref_err = 0.0
    for sl, (_, r) in zip(spans, parts):
        for lo in (0, sl.stop - sl.start - 512):
            ref = torch.as_tensor(ck.philox_normal_reference(
                seed, 512, D, sl.start + lo)).to(device)
            ref_err = max(ref_err, require_close(
                r[lo:lo + 512], ref, "row-offset draw vs numpy Philox",
                0.0, 1e-5))
    report["row_offset_split"] = dict(
        rows=total, shares=[sl.stop - sl.start for sl in spans],
        joined_equals_one_launch="bit for bit",
        numpy_philox_max_abs_err=ref_err, tolerance=dict(rtol=0, atol=1e-5))
    say(phase="mesh_serving_path", card=card, rows=ROWS, mesh=repr(mesh),
        backend="nccl", launches=launches, **report)
    return launches, report


def drive_mesh_inference(device, mesh, card):
    """The four particle entry points with ``mesh=`` of one NCCL rank
    against the same calls without it, from the same generator state:
    ``flow_mcmc`` (independence, 4,096 chains) and ``sample_with_rejection``
    (2^16 rows) on the flagship chain, ``fit_variational`` on it (1,024
    particles), ``run_smc`` at d 32 with 2^16 particles. Bit for bit where
    the arithmetic is the same; where a mean over the axis is a sum over the
    ranks divided by the count, the difference, its reason and the gate of
    the inference phases (``MCMC_TOL``)."""
    rng = np.random.default_rng(SEED + 61)
    meta, _, _, theta_tuple = flagship_inputs(rng, N_COND, 16, device,
                                              "mesh-inference")
    chain = wide_chain(False, rng, device)
    mean_reason = ("the mesh path sums over the axis and divides by the "
                   "count where the one-process path takes a mean")

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def flow_of(model):
        return dt.Flow(copy.deepcopy(model), meta, device=device)

    flow = flow_of(chain)

    def log_density(x):
        return flow.log_prob(x, theta_tuple)

    report, launches = {}, {}
    runs = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        reset_counts()
        t0 = time.perf_counter()
        kept, diag = dt.flow_mcmc(
            flow, log_density, theta=theta_tuple,
            n_chains=MESH_MCMC["chains"], n_steps=MESH_MCMC["steps"],
            burn_in=MESH_MCMC["burn_in"], generator=gen(SEED + 1), mesh=m)
        torch.cuda.synchronize()
        runs[tag] = (kept, torch.as_tensor(diag["accept_rate"]),
                     time.perf_counter() - t0, read_counts())
    launches["flow_mcmc"] = runs["mesh"][3]
    if runs["mesh"][3]["chain_apply"] != 2 * (MESH_MCMC["steps"] + 1):
        fail(f"flow_mcmc(mesh=...): launches {runs['mesh'][3]}")
    report["flow_mcmc"] = dict(
        chains=MESH_MCMC["chains"], steps=MESH_MCMC["steps"],
        seconds=runs["mesh"][2], seconds_no_mesh=runs["none"][2],
        draws=same_or_gated(runs["mesh"][0], runs["none"][0],
                            "flow_mcmc(mesh=...) draws", mean_reason,
                            **MCMC_TOL),
        accept_rate=same_or_gated(runs["mesh"][1], runs["none"][1],
                                  "flow_mcmc(mesh=...) accept rate",
                                  mean_reason, 0.0, 1e-6))

    cut = float(torch.median(flow.sample(
        (4096,), theta_tuple, generator=gen(SEED + 2))[:, 0]))
    outs = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        reset_counts()
        outs[tag] = (dt.sample_with_rejection(
            flow, REJECTION_SAMPLES, lambda v: v[..., 0] > cut, theta_tuple,
            generator=gen(SEED + 3), mesh=m), read_counts())
    launches["sample_with_rejection"] = outs["mesh"][1]
    report["sample_with_rejection"] = dict(
        rows=REJECTION_SAMPLES, rounds=outs["mesh"][1]["chain_apply"],
        draws=same_or_gated(outs["mesh"][0], outs["none"][0],
                            "rejection(mesh=...)", mean_reason, **MCMC_TOL))

    vi = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        f = flow_of(chain)
        t0 = time.perf_counter()
        dt.fit_variational(
            f, lambda v: -0.5 * (v * v).sum(-1), theta=theta_tuple,
            steps=MESH_VI["steps"], n_particles=MESH_VI["particles"],
            generator=gen(SEED + 4), mesh=m)
        torch.cuda.synchronize()
        vi[tag] = (torch.as_tensor(f.train_loss),
                   torch.cat([p.detach().reshape(-1)
                              for p in ft.trainable_leaves(f.model)]),
                   time.perf_counter() - t0)
    report["fit_variational"] = dict(
        steps=MESH_VI["steps"], particles=MESH_VI["particles"],
        seconds=vi["mesh"][2], seconds_no_mesh=vi["none"][2],
        losses=same_or_gated(vi["mesh"][0], vi["none"][0],
                             "fit_variational(mesh=...) losses",
                             mean_reason, 0.0, 1e-4),
        parameters=same_or_gated(vi["mesh"][1], vi["none"][1],
                                 "fit_variational(mesh=...) parameters",
                                 mean_reason, 0.0, 1e-4))

    d = SMC["d"]
    mu = torch.linspace(-1.0, 1.0, d, device=device)

    def log_p(v):
        return -0.5 * ((v - mu) ** 2).sum(-1)

    smc = {}
    for tag, m in (("mesh", mesh), ("none", None)):
        t0 = time.perf_counter()
        parts, log_w, diag = dt.run_smc(
            log_p, d, SMC["particles"], n_steps=SMC["steps"],
            mh_step_size=SMC["mh_step"], n_mh=SMC["n_mh"],
            generator=gen(SEED + 77), mesh=m, device=device)
        torch.cuda.synchronize()
        smc[tag] = (parts, log_w, diag, time.perf_counter() - t0)
    report["run_smc"] = dict(
        d=d, particles=SMC["particles"], steps=SMC["steps"],
        seconds=smc["mesh"][3], seconds_no_mesh=smc["none"][3],
        resampled_steps=int((smc["mesh"][2]["ess"]
                             < 0.5 * SMC["particles"]).sum()),
        particles_=same_or_gated(smc["mesh"][0], smc["none"][0],
                                 "run_smc(mesh=...) particles", mean_reason,
                                 **MCMC_TOL),
        ess=same_or_gated(smc["mesh"][2]["ess"], smc["none"][2]["ess"],
                          "run_smc(mesh=...) ESS", mean_reason, 1e-5, 0.0),
        mh_accept=same_or_gated(smc["mesh"][2]["mh_accept"],
                                smc["none"][2]["mh_accept"],
                                "run_smc(mesh=...) acceptance", mean_reason,
                                0.0, 1e-6))
    say(phase="mesh_inference_path", card=card, mesh=repr(mesh),
        backend="nccl", launches=launches, **report)
    return launches, report


def drive_instruments(device, card, tmp):
    """``StepTimer`` around ``log_prob`` at 2^18 rows against the CUDA-event
    median of ``time_ms`` (a timer that did not wait would read the enqueue
    only); ``trace`` + ``annotate`` around one ``log_prob``: the Chrome
    trace holds the chain kernel's symbol and the region's name;
    ``Throughput``."""
    from densityflows_tpu_torch.utils import profiling as prof

    rng = np.random.default_rng(SEED + 73)
    meta, x, theta, _ = flagship_inputs(rng, N_COND, ROWS, device, "instr")
    flow = dt.Flow(wide_chain(False, rng, device), meta, device=device)
    with torch.no_grad():
        event_ms = time_ms(lambda: flow.log_prob(x, theta), warmup=2, runs=9)
        timer = prof.StepTimer()
        meter = prof.Throughput()
        for _ in range(9):
            timer.start()
            lp = flow.log_prob(x, theta)
            meter.add(ROWS, timer.stop(lp))
        if timer.p50_ms < 0.95 * event_ms:
            fail(f"StepTimer p50 {timer.p50_ms:.3f} ms < 0.95 x the event "
                 f"median {event_ms:.3f} ms: it did not wait for the card")
        logdir = os.path.join(tmp, "trace")
        with prof.trace(logdir):
            with prof.annotate("df_smoke_log_prob"):
                flow.log_prob(x, theta)
            torch.cuda.synchronize()
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    if len(files) != 1:
        fail(f"trace wrote {files}")
    with open(os.path.join(logdir, files[0])) as f:
        text = f.read()
    for needle in ("chain_apply_kernel", "df_smoke_log_prob"):
        if needle not in text:
            fail(f"the trace does not hold {needle!r}")
    report = dict(rows=ROWS, step_timer_p50_ms=timer.p50_ms,
                  step_timer_mean_ms=timer.mean_ms,
                  step_timer_p99_ms=timer.p99_ms, cuda_event_median_ms=event_ms,
                  p50_over_event_median=timer.p50_ms / event_ms,
                  trace_bytes=len(text),
                  trace_holds=["chain_apply_kernel", "df_smoke_log_prob"],
                  rows_per_sec=meter.per_sec,
                  rows_per_sec_per_chip=meter.per_sec_per_chip,
                  device_count=prof.device_count())
    say(phase="instruments", card=card, **report)
    return report


def drive_scaling(device, card):
    """``scaling_report`` at ``benchmarks/scaling.py``'s config on the one
    card (``device_counts=[1]``, a one-rank NCCL group): the train step
    ``train(mesh=...)`` takes (``step_grads`` + folded Adam) and the
    ``Flow.sample(mesh=...)`` sweep (``chain_sample``)."""
    from densityflows_tpu_torch.parallel.scaling import scaling_report

    d, n, h = SCALING["d"], SCALING["n"], SCALING["hidden"]
    x_ref = np.random.default_rng(SEED).normal(size=(256, d)).astype(
        np.float32)

    def make_model(generator):
        return dt.flow_chain(
            *[dt.coupling_block(d, None, n=n, generator=generator,
                                hidden_dim_s=h, hidden_dim_t=h,
                                device=device) for _ in range(2)],
            dt.normalization_layer(x_ref, -1.0, 1.0, device=device))

    reset_counts()
    t0 = time.perf_counter()
    pts = scaling_report(make_model, d, n, per_device_batch=SCALING["batch"],
                         reps=SCALING["reps"], device_counts=[1],
                         device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    p = pts[0]
    if p.train_path != "fused-step-mesh" or counts["step_grads"] < 1:
        fail(f"scaling_report's train step took {p.train_path} "
             f"({counts})")
    if counts["chain_sample"] < 1 or p.train_efficiency != 1.0:
        fail(f"scaling_report's sweep: {counts}, {p}")
    report = dict(config=f"d {d}, n {n}, 2 blocks hidden {h} + "
                         "normalization", per_device_batch=SCALING["batch"],
                  reps=SCALING["reps"], n_devices=p.n_devices,
                  train_samples_per_sec=p.train_samples_per_sec,
                  sample_draws_per_sec=p.sample_draws_per_sec,
                  train_spread=p.train_spread,
                  sample_spread=p.sample_spread,
                  train_efficiency=p.train_efficiency,
                  sample_efficiency=p.sample_efficiency,
                  train_method=p.train_method, sample_method=p.sample_method,
                  train_path=p.train_path, launches=counts, seconds=seconds)
    say(phase="scaling_main_path", card=card, **report)
    return counts, report


def drive_mesh_one_rank(device, card, tmp):
    """The one-rank NCCL phases: serving, inference and the scaling
    harness on one process group."""
    import torch.distributed as dist

    dt.distributed_init(f"file://{tmp}/mesh_rendezvous", 1, 0,
                        backend="nccl")
    try:
        mesh = dt.make_mesh()
        if mesh.group is None or mesh.size != 1:
            fail(f"mesh: {mesh}")
        serve = drive_mesh_serving(device, mesh, card)
        infer = drive_mesh_inference(device, mesh, card)
        scaling = drive_scaling(device, card)
    finally:
        dist.destroy_process_group()
    return serve, infer, scaling


# the two-rank phase: two processes on the one card over gloo (NCCL refuses
# two ranks on one device); this script is the worker
def mesh_rank_main(rank, world, init_file, out_dir):
    """One rank of ``mesh_two_ranks``: a (2, 1) data mesh serving the
    flagship chain, then a (1, 2) model mesh training it tensor-parallel;
    rank 0 also runs the one-process references. Then ``sharded_ckpt``:
    the tensor-parallel chain and its Adam state through
    ``save_flow_orbax`` (each rank writes its shards), a one-process load
    on rank 0 served against the gathered chain, and a load onto the (1, 2)
    mesh that trains on against the run that went on. Writes
    ``rank_<rank>.json``."""
    from densityflows_tpu_torch.parallel.mesh import shard_params_tp
    from densityflows_tpu_torch.utils.checkpoint import (
        _gather_tp,
        element_leaves,
    )
    from densityflows_tpu_torch.utils.orbax_ckpt import (
        load_flow_orbax,
        save_flow_orbax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    dt.distributed_init(f"file://{init_file}", world, rank, backend="gloo")
    rng = np.random.default_rng(SEED + 79)
    meta, x, theta, theta_tuple = flagship_inputs(rng, N_COND, ROWS, device,
                                                  "two-ranks")
    chain = wide_chain(False, rng, device)
    flow = dt.Flow(copy.deepcopy(chain), meta, device=device)
    out = {"rank": rank}

    dp = dt.make_mesh((2, 1), ("data", "model"))
    gen = lambda: torch.Generator().manual_seed(SEED + 6)  # noqa: E731
    (lp, smp), counts = counted(lambda: (
        flow.log_prob(x, theta, mesh=dp),
        flow.sample((ROWS,), theta_tuple, generator=gen(), mesh=dp)))
    out["serving_launches"] = counts
    t0 = time.perf_counter()
    with torch.no_grad():
        flow.log_prob(x, theta, mesh=dp)
    torch.cuda.synchronize()
    out["log_prob_seconds"] = time.perf_counter() - t0
    if rank == 0:
        with torch.no_grad():
            out["log_prob_bit_equal"] = bits_same(lp, flow.log_prob(x, theta))
            out["sample_bit_equal"] = bits_same(
                smp, flow.sample((ROWS,), theta_tuple, generator=gen()))

    tp_mesh = dt.make_mesh((1, 2), ("data", "model"))
    tp_flow = dt.Flow(copy.deepcopy(chain), meta, device=device)
    tp_flow.model = shard_params_tp(tp_mesh, tp_flow.model)
    if fc.chain_is_fusable(tp_flow.model, D, N_COND):
        raise SystemExit("the chain kernel would take a tensor-parallel chain")
    xb = torch.as_tensor((rng.normal(size=(TP["steps"] * TP["batch"], D))
                          * 0.5).astype(np.float32)).to(device)
    thb = torch.as_tensor(rng.uniform(size=(TP["steps"] * TP["batch"],
                                            N_COND)).astype(np.float32)
                          ).to(device)
    mask = torch.ones(TP["batch"], device=device)
    # the rows of the steps after the checkpoint, drawn after the others
    rows_more = CKPT_MORE_STEPS * TP["batch"]
    xb = torch.cat([xb, torch.as_tensor((rng.normal(size=(rows_more, D))
                                         * 0.5).astype(np.float32)
                                        ).to(device)])
    thb = torch.cat([thb, torch.as_tensor(rng.uniform(size=(
        rows_more, N_COND)).astype(np.float32)).to(device)])
    opt = dt.adam(1e-3)

    def steps(model, mesh, state=None, first=0, count=TP["steps"]):
        step = dt.make_train_step(opt, mesh=mesh)
        if state is None:
            state = opt.init(ft.trainable_leaves(model))
        losses = []
        for i in range(first, first + count):
            rows = slice(i * TP["batch"], (i + 1) * TP["batch"])
            _, state, loss = step(model, state, dt.StandardNormal(D),
                                  xb[rows], thb[rows], mask)
            losses.append(float(loss))
        return losses, state

    t0 = time.perf_counter()
    out["tp_losses"], tp_state = steps(tp_flow.model, tp_mesh)
    torch.cuda.synchronize()
    out["tp_seconds"] = time.perf_counter() - t0
    gathered = _gather_tp(tp_flow.model, None)[0]
    if rank == 0:
        rep = copy.deepcopy(chain)
        t0 = time.perf_counter()
        out["rep_losses"] = steps(rep, None)[0]
        torch.cuda.synchronize()
        out["rep_seconds"] = time.perf_counter() - t0
        diffs = [(a.detach() - b.detach()).abs() for a, b in zip(
            ft.trainable_leaves(gathered), ft.trainable_leaves(rep))]
        out["param_max_abs_err"] = max(float(e.max()) for e in diffs)
        out["params_past_1e-4"] = sum(int((e > 1e-4).sum()) for e in diffs)
        out["params"] = sum(e.numel() for e in diffs)

    # sharded_ckpt: save_flow_orbax of the shards and their Adam state
    ckpt = os.path.join(out_dir, "sharded_ckpt")
    saved = [t.detach().clone() for t in element_leaves(tp_flow.model)]
    # twice: the first call also imports and sets DCP up; the second
    # overwrites the first's checkpoint
    out["orbax_save_seconds"] = []
    for _ in range(2):
        tp_mesh.barrier()
        t0 = time.perf_counter()
        save_flow_orbax(ckpt, tp_flow, tp_state)
        out["orbax_save_seconds"].append(time.perf_counter() - t0)
    tp_mesh.barrier()
    t0 = time.perf_counter()
    dt.save_flow(os.path.join(out_dir, "gathered_ckpt"), tp_flow, tp_state,
                 erase=True)
    out["save_flow_seconds"] = time.perf_counter() - t0
    tp_mesh.barrier()
    if rank == 0:
        # one process: the replicated flow on the chain kernels, against
        # the chain the shards gather into
        t0 = time.perf_counter()
        one = load_flow_orbax(ckpt, device=device)
        torch.cuda.synchronize()
        out["one_process_load_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dt.load_flow(os.path.join(out_dir, "gathered_ckpt"), device=device)
        torch.cuda.synchronize()
        out["load_flow_seconds"] = time.perf_counter() - t0
        out["one_process_leaves_bit_equal"] = all(
            bits_same(a, b) for a, b in zip(element_leaves(one.model),
                                            element_leaves(gathered)))
        ref = dt.Flow(gathered, meta, device=device)
        with torch.no_grad():
            (lp1, s1), counts = counted(lambda: (
                one.log_prob(x, theta),
                one.sample((ROWS,), theta_tuple, generator=gen())))
            out["one_process_launches"] = counts
            out["one_process_log_prob_bit_equal"] = bits_same(
                lp1, ref.log_prob(x, theta))
            out["one_process_sample_bit_equal"] = bits_same(
                s1, ref.sample((ROWS,), theta_tuple, generator=gen()))
            out["one_process_finite"] = bool(torch.isfinite(lp1).all()
                                             and torch.isfinite(s1).all())
        del one, ref, lp1, s1
    tp_mesh.barrier()
    # onto the (1, 2) mesh: this rank's chunks, then 4 more steps beside
    # the run that goes on from memory
    t0 = time.perf_counter()
    loaded, loaded_state = load_flow_orbax(ckpt, opt, mesh=tp_mesh,
                                           device=device)
    torch.cuda.synchronize()
    out["mesh_load_seconds"] = time.perf_counter() - t0
    out["loaded_shards_bit_equal"] = all(
        bits_same(a, b) for a, b in zip(element_leaves(loaded.model), saved))
    out["loaded_state_bit_equal"] = loaded_state.count == tp_state.count \
        and all(bits_same(a, b) for a, b in zip(
            loaded_state.mu + loaded_state.nu, tp_state.mu + tp_state.nu))
    more = dict(first=TP["steps"], count=CKPT_MORE_STEPS)
    out["uninterrupted_losses"] = steps(tp_flow.model, tp_mesh, tp_state,
                                        **more)[0]
    out["resumed_losses"] = steps(loaded.model, tp_mesh, loaded_state,
                                  **more)[0]
    out["resumed_shards_bit_equal"] = all(
        bits_same(a, b) for a, b in zip(element_leaves(loaded.model),
                                        element_leaves(tp_flow.model)))
    tp_mesh.barrier()
    with open(os.path.join(out_dir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


def drive_mesh_two_ranks(card, tmp):
    """``mesh_two_ranks``: this script twice on the one card, as two gloo
    ranks (file rendezvous, a time limit each): a (2, 1) mesh's
    ``log_prob`` / ``sample`` at 2^18 rows equal one process bit for bit; a
    (1, 2) mesh trains the wide chain tensor-parallel for 8 steps at batch
    1,024, against the replicated chain in one process (losses rtol 1e-5,
    gathered parameters 1e-4 but for at most 8 coordinates, 3e-4 all)."""
    init = os.path.join(tmp, "two_ranks_rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="4")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "2", init, tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=MESH_TWO_RANKS_TIMEOUT)
            logs.append(o[-2000:] + e[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail("mesh_two_ranks: a rank did not finish in time")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"mesh_two_ranks: rank {r} failed:\n{log}")
    res = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank_{r}.json")) as f:
            res.append(json.load(f))
    r0, r1 = res
    if not (r0["log_prob_bit_equal"] and r0["sample_bit_equal"]):
        fail("mesh_two_ranks: the (2, 1) mesh's log_prob / sample differ "
             "from one process")
    for r in res:
        if not launches_are(r["serving_launches"], chain_apply=1,
                            chain_sample=1):
            fail(f"mesh_two_ranks: rank launches {r['serving_launches']}")
    if r0["tp_losses"] != r1["tp_losses"]:
        fail("mesh_two_ranks: the ranks' tensor-parallel losses differ")
    loss_err = float(np.max(np.abs(np.asarray(r0["tp_losses"])
                                   - np.asarray(r0["rep_losses"]))
                            / np.abs(np.asarray(r0["rep_losses"]))))
    if loss_err > TP["loss_rtol"] or r0["param_max_abs_err"] > \
            TP["param_atol"] or r0["params_past_1e-4"] > TP["past_1e-4"]:
        fail(f"mesh_two_ranks: tensor-parallel training off the replicated "
             f"chain: loss rel err {loss_err}, parameters "
             f"{r0['param_max_abs_err']}, {r0['params_past_1e-4']} past "
             "1e-4")
    report = dict(
        backend="gloo (collectives of CUDA tensors through host copies)",
        ranks=2, rows=ROWS, serving_mesh="(2, 1) data x model",
        log_prob_and_sample_vs_one_process="bit for bit",
        serving_launches_per_rank=r0["serving_launches"],
        log_prob_seconds_per_rank=[r["log_prob_seconds"] for r in res],
        tp_mesh="(1, 2) data x model", tp_steps=TP["steps"],
        tp_batch=TP["batch"], tp_losses=r0["tp_losses"],
        tp_loss_max_rel_err_vs_replicated=loss_err,
        tp_param_max_abs_err_vs_replicated=r0["param_max_abs_err"],
        tp_params_past_1e_4=r0["params_past_1e-4"], tp_params=r0["params"],
        tp_seconds=r0["tp_seconds"], replicated_seconds=r0["rep_seconds"],
        tolerance=dict(loss_rtol=TP["loss_rtol"],
                       param_atol=TP["param_atol"],
                       params_past_1e_4=TP["past_1e-4"]),
        seconds=time.time() - t0)
    say(phase="mesh_two_ranks", card=card, **report)
    return report, sharded_ckpt_report(res, tmp, card)


def written_shards(ckpt):
    """The ``sharded_ckpt`` gate on the files: DCP's ``.metadata`` of the
    (1, 2) checkpoint says that every sharded leaf and both its moments are
    two chunks, model rank m's in ``__m_0.distcp`` (so no file holds a
    whole sharded tensor), and every replicated one a single whole chunk.
    Returns the count of sharded tensors and each store's file sizes."""
    from densityflows_tpu_torch.parallel.mesh import Mesh, shard_params_tp
    from densityflows_tpu_torch.utils.checkpoint import (
        _leaf_key,
        _leaf_shard_dims,
        element_from_spec,
        element_leaves,
    )
    from densityflows_tpu_torch.utils.orbax_ckpt import _stored_chunks

    with open(os.path.join(ckpt, "flow.json")) as f:
        model = element_from_spec(json.load(f)["model_spec"], "cpu")
    one_rank = Mesh(None, 1, 0, model_size=2, model_rank=0,
                    axis_names=("data", "model"))
    dims = _leaf_shard_dims(shard_params_tp(one_rank, model))
    sharded, sizes = 0, {}
    for store, prefixes in (("model", ("",)), ("opt_state", ("mu/", "nu/"))):
        path = os.path.join(ckpt, store)
        chunks = _stored_chunks(path)
        for prefix in prefixes:
            for i, (t, dm) in enumerate(zip(element_leaves(model), dims)):
                key, full = prefix + _leaf_key(i), tuple(t.shape)
                got = sorted(chunks[key])
                if dm is None:
                    ok = len(got) == 1 and got[0][:2] == ((0,) * len(full),
                                                          full)
                else:
                    want = []
                    for m in range(2):
                        off, size = [0] * len(full), list(full)
                        step = full[dm[1]] // 2
                        off[dm[1]], size[dm[1]] = m * step, step
                        want.append((tuple(off), tuple(size),
                                     f"__{m}_0.distcp"))
                    ok = got == want
                    sharded += 1
                if not ok:
                    fail(f"sharded_ckpt: {store} {key} stored as {got}")
        sizes[store] = {f: os.path.getsize(os.path.join(path, f))
                        for f in sorted(os.listdir(path))}
    if not sharded:
        fail("sharded_ckpt: no leaf was written sharded")
    return sharded, sizes


def sharded_ckpt_report(res, tmp, card):
    """``sharded_ckpt``: the gates on what the ranks of ``mesh_two_ranks``
    did with ``save_flow_orbax`` / ``load_flow_orbax`` (written shards, the
    one-process load on the chain kernels against the gathered chain, 4
    steps resumed on the (1, 2) mesh against the run that went on), and
    the save and load times and bytes beside ``save_flow`` /
    ``load_flow`` of the same chain and state (which gather)."""
    r0, r1 = res
    ckpt = os.path.join(tmp, "sharded_ckpt")
    sharded, sizes = written_shards(ckpt)
    if not (r0["one_process_leaves_bit_equal"]
            and r0["one_process_log_prob_bit_equal"]
            and r0["one_process_sample_bit_equal"]
            and r0["one_process_finite"]):
        fail("sharded_ckpt: the one-process load differs from the gathered "
             "chain")
    if not launches_are(r0["one_process_launches"], chain_apply=1,
                        chain_sample=1):
        fail(f"sharded_ckpt: one-process launches "
             f"{r0['one_process_launches']}")
    for r in res:
        if not (r["loaded_shards_bit_equal"] and r["loaded_state_bit_equal"]
                and r["resumed_shards_bit_equal"]
                and r["resumed_losses"] == r["uninterrupted_losses"]):
            fail(f"sharded_ckpt: rank {r['rank']} resumed off the run that "
                 "went on")
    if r0["resumed_losses"] != r1["resumed_losses"]:
        fail("sharded_ckpt: the ranks' resumed losses differ")
    gathered = os.path.join(tmp, "gathered_ckpt")
    npz_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(gathered) for f in files)
    report = dict(
        config=f"d {D}, n {N_COND}, {N_BLOCKS} blocks hidden {HIDDEN}",
        mesh="(1, 2) data x model, two gloo ranks",
        saved_after_steps=TP["steps"], resumed_steps=CKPT_MORE_STEPS,
        sharded_tensors=sharded, written_shards="each rank only its own",
        bytes_by_store_and_file=sizes,
        orbax_save_seconds_first_then_second_per_rank=[
            r["orbax_save_seconds"] for r in res],
        save_flow_seconds_per_rank=[r["save_flow_seconds"] for r in res],
        save_flow_bytes_rank_0=npz_bytes,
        one_process_load_seconds=r0["one_process_load_seconds"],
        load_flow_seconds=r0["load_flow_seconds"],
        mesh_load_seconds_per_rank=[r["mesh_load_seconds"] for r in res],
        one_process_launches=r0["one_process_launches"], rows=ROWS,
        one_process_log_prob_and_sample_vs_gathered="bit for bit",
        resumed_losses=r0["resumed_losses"],
        resumed_vs_uninterrupted="bit for bit (losses, shards)")
    say(phase="sharded_ckpt", card=card, **report)
    return report


def chunked_fold_probe(device, card, sizes=(ROWS,)):
    """The measurement behind ROADMAP A.6 (the JAX package's row-chunked
    folds): ``log_prob`` of the RQS chain (benchmarks/spline_crossover.py's
    widest config) and of a chain the chain kernel declines (the 4-block MAF
    flow of maf_main_path) at each row count of ``sizes`` (here 2^18;
    ``tools/chip_probe.py --only a6`` adds 2^20), straight and as a loop
    over 4,096- and 16,384-row slices, each with its time (CUDA events, the
    faster of two runs after the reference run) and its peak of allocated
    device memory above the inputs."""
    rng = np.random.default_rng(SEED + 83)
    big = max(sizes)
    meta, x, theta, _ = flagship_inputs(rng, N_COND, big, device, "a6")
    rqs = dt.Flow(rqs_chain(rng, device), meta, device=device)
    th01 = rng.uniform(size=(SEQ_ROWS, N_COND)).astype(np.float32)
    dset = dt.DataArrays.make(
        (rng.normal(size=(SEQ_ROWS, D)) * 0.5).astype(np.float32),
        meta.theta_min + (meta.theta_max - meta.theta_min) * th01, rng=0)
    maf = dt.build_flow(dt.FlowConfig(net=dt.NetConfig(hidden_dim_t=HIDDEN),
                                      n_blocks=N_BLOCKS, family="maf"),
                        dset, generator=torch.Generator().manual_seed(SEED),
                        device=device)
    numpy_weights_(maf.model, rng, 0.1)
    report = {}
    for name, flow in (("rqs", rqs), ("maf_declined", maf)):
        if fc.chain_is_fusable(flow.model, D, N_COND):
            fail(f"chunked_fold_probe: the chain kernel takes {name}")
        rows_report = {}
        for rows in sizes:
            xs, ts = x[:rows], theta[:rows]

            def straight():
                return flow.log_prob(xs, ts)

            def looped(chunk):
                return lambda: torch.cat([
                    flow.log_prob(xs[i:i + chunk], ts[i:i + chunk])
                    for i in range(0, rows, chunk)])

            with torch.no_grad():
                want = straight()
                entry = {}
                for label, fn in [("straight", straight)] + [
                        (f"chunks_{c}", looped(c)) for c in CHUNK_ROWS]:
                    # two timed runs; the first one's peak memory
                    times = []
                    for run in range(2):
                        torch.cuda.synchronize()
                        base = torch.cuda.memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        got = fn()
                        e1.record()
                        torch.cuda.synchronize()
                        times.append(e0.elapsed_time(e1))
                        if run == 0:
                            peak = torch.cuda.max_memory_allocated() - base
                            err = float((got - want).abs().max())
                        del got
                    entry[label] = dict(ms=min(times), ms_runs=times,
                                        peak_mib=peak / 2**20,
                                        max_abs_err_vs_straight=err)
            rows_report[str(rows)] = entry
        report[name] = rows_report
    say(phase="chunked_fold_probe", card=card,
        config=f"d {D}, n {N_COND}, {N_BLOCKS} blocks hidden {HIDDEN}",
        **report)
    return report


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
    stream_errs, stream_skips = check_stream_small_designs(rng, device)
    errs["train_stream"] = max(stream_errs.values())
    say(phase="stream_kernel_small", max_abs_err_by_case=stream_errs,
        skipped_updates=stream_skips, tolerance=TRAIN_TOL,
        two_launches_equal="bit for bit",
        two_chunked_calls_equal_one_call="bit for bit")

    # phase 3g: coupling_fwd / coupling_bwd against their plain versions
    coupling_errs, coupling_ratios = check_coupling_small(device)
    say(phase="coupling_kernel_small", max_abs_err_by_case=coupling_errs,
        gate_ratio_by_case=coupling_ratios, tolerance=KERNEL_TOL,
        two_launches_equal="bit for bit")

    # phase 3h: train_run's member axis, K = 3 small members in one launch
    member_errs, member_skips = check_ensemble_small(rng, device)
    errs["train_run"] = max(errs["train_run"], max(member_errs.values()))
    say(phase="ensemble_kernel_small", members=ENSEMBLE_K_SMALL,
        max_abs_err_by_case=member_errs, skipped_updates=member_skips,
        tolerance=TRAIN_TOL, members_equal_own_launch="bit for bit")

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

    # phase 4g: the other bases, spline / MAF / IAF / embedded flows; each
    # phase prints its own line (launch counts read around each driven call)
    t_new = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        drive_bases(device, tmp, card)
    drive_rqs(device, card)
    drive_maf(device, card)
    drive_embed(device, card)
    drive_mixed_coupling(device, card)
    summary["families_seconds"] = time.time() - t_new

    # phase 4h: the inference engine (A12) on the flagship chain and at
    # BASELINE's widths; each phase prints its own line
    t_new = time.time()
    inference_launches, _ = drive_inference(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        snpe_launches, _ = drive_snpe(device, tmp, card)
    summary["inference_seconds"] = time.time() - t_new

    # phase 4i: the deep ensemble on train_run's member axis, precision and
    # memory options at the flagship width, the uncertainty example
    t_new = time.time()
    summary["adam_update"] = check_adam_update(device, card)[
        "foreach_vs_per_leaf"]
    with tempfile.TemporaryDirectory() as tmp:
        ensemble = drive_ensemble(device, tmp, card)
    precision = drive_precision(device, card)
    example = drive_example_uncertainty(card)
    summary["a13_seconds"] = time.time() - t_new
    summary["example_uncertainty_seconds"] = example["seconds"]

    # phase 4j: mesh= on serving and the inference engine (one NCCL rank),
    # two gloo ranks on the card (a data mesh, a tensor-parallel model
    # mesh), the instruments, the scaling harness, and the A.6 probe
    t_new = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        (serve_launches, _), (infer_launches, _), (scaling_launches, _) = \
            drive_mesh_one_rank(device, card, tmp)
        summary["mesh_two_ranks"], summary["sharded_ckpt"] = \
            drive_mesh_two_ranks(card, tmp)
        summary["instruments"] = drive_instruments(device, card, tmp)
    chunked_fold_probe(device, card)
    summary["a9_a4_seconds"] = time.time() - t_new

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
         "bwd": max(small, report["each_step_max_abs_err_same_weights"]),
         "fwd_gate_ratio": max(r["fwd"] for r in coupling_ratios.values()),
         "bwd_gate_ratio": max(r["bwd"] for r in coupling_ratios.values()),
         "fwd_gate_ratio_main_shape": coupling_ratios["main_shape"]["fwd"]},
        card))
    # the inference engine's paths through the chain and whole-run kernels
    a12 = {
        "chain_apply": dict(
            {f"flow_mcmc_{m}": inference_launches[m]
             for m in ("independence", "neutra")},
            sample_with_rejection=inference_launches["sample_with_rejection"],
            fit_posterior_rounds=snpe_launches["chain_apply"]),
        "chain_sample": dict(sbc_ranks=inference_launches["sbc_ranks"],
                             fit_posterior_rounds=snpe_launches[
                                 "chain_sample"]),
        "train_run": dict(fit_posterior_rounds=snpe_launches["train_run"]),
    }
    for row in kernels:
        if row["name"] in a12:
            row["launches_on_inference_phases"] = a12[row["name"]]
        if row["name"] == "train_run":
            row["member_axis"] = dict(
                members=ENSEMBLE_K,
                launches_on_ensemble_main_path=ensemble[
                    "train_run_launches"],
                one_launch_ms=ensemble["one_launch_ms"],
                k_launches_ms=ensemble["k_launches_ms"],
                plain_program_epochs=ensemble["plain_program_epochs"],
                eager_program_ms=ensemble["eager_program_ms"],
                vmapped_program_ms=ensemble["vmapped_program_ms"],
                bound_ms=ensemble["bound_ms_k"],
                ms_by_members={k: v["ms"]
                               for k, v in ensemble["sweep"].items()})
        mesh_paths = {
            "chain_apply": dict(
                log_prob_mesh=serve_launches["log_prob"]["chain_apply"],
                flow_mcmc_mesh=infer_launches["flow_mcmc"]["chain_apply"],
                sample_with_rejection_mesh=infer_launches[
                    "sample_with_rejection"]["chain_apply"],
                mesh_two_ranks_per_rank=1,
                sharded_ckpt_one_process_load=summary["sharded_ckpt"][
                    "one_process_launches"]["chain_apply"]),
            "chain_sample": dict(
                sample_mesh=serve_launches["sample"]["chain_sample"],
                sample_sweep_mesh=serve_launches["sample_sweep"][
                    "chain_sample"],
                row_offset_split=4, mesh_two_ranks_per_rank=1,
                scaling_report=scaling_launches["chain_sample"],
                sharded_ckpt_one_process_load=summary["sharded_ckpt"][
                    "one_process_launches"]["chain_sample"]),
            "step_grads": dict(
                scaling_report=scaling_launches["step_grads"]),
        }
        if row["name"] in mesh_paths:
            row["launches_on_mesh_phases"] = mesh_paths[row["name"]]
        if row["name"] in ("chain_apply", "chain_sample"):
            row["launches_on_a13_phases"] = (
                dict(ensemble["chain_apply_launches"],
                     bf16_log_prob=precision["bf16_chain_launches"][
                         "log_prob"])
                if row["name"] == "chain_apply" else
                dict(bf16_sample=precision["bf16_chain_launches"]["sample"]))

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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5]))
    sys.exit(main())
