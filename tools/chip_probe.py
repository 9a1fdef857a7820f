#!/usr/bin/env python3
"""Probes of the PyTorch / CUDA port on one NVIDIA GPU, beside chip_smoke.py.

    python3 tools/chip_probe.py [--out chiprun_out/probe.json]

Measures what ``chip_smoke.py`` does not gate, through the package's public
wrappers only, so that the same script runs on two trees of the port:

- ``chain_nan``: a row holding a NaN through a relu chain that ends in a
  ``LogitLayer``: the NaN pattern of ``chain_apply`` (forward and inverse,
  with ldj) and ``chain_sample`` (a NaN condition row) against their plain
  versions. Reported as counts of entries whose NaN-ness differs; the
  probe does not fail on them (``chip_smoke.py`` does);
- ``step_host``: ``StepPlan.loss_and_grads`` at the streaming path's "med"
  shape (batch 1024) and at the README / BASELINE shape (batch 64): one
  call timed by CUDA events (``call_ms``), the host clock per call over
  back-to-back calls without a synchronisation (``host_enqueue_ms``), the
  CUDA-event time per call over those calls (``back_to_back_ms``), and the
  kernels' device time from ``torch.profiler`` (``device_ms_by_kernel``);
- ``stream``: one epoch of ``train_stream`` at the stream main path's "med"
  shape (922 steps): ms per epoch and per step, the launch shape and the
  sha256 of the per-step losses and snapshots (the bits two trees share);
  then 50 epochs at the README / BASELINE config beside ``train_run``;
- ``chain``: ``chain_apply`` (inverse with ldj) and ``chain_sample`` on the
  wide split chain at 2^18 rows, CUDA-event and profiler device ms, at every
  row tile;
- ``families``: ``chip_smoke.py``'s phases of the families without a kernel
  (other bases, spline, MAF / IAF, embedding, the spline + RealNVP step),
  seconds per phase; ``mixed_grads``: that step's gradients on the same
  weights, the kernels and their plain versions against autograd, per step;
- ``coupling``: ``coupling_bwd`` at the opt-in train step's shape (8192 rows,
  K 24, A 16, hidden 256, three dense layers per net): call time, the
  device time of each kernel and of each launch from ``torch.profiler``,
  ``coupling_fwd``'s call and device time, and the time of six
  ``w.t().contiguous()`` copies of the nets' weights;
- ``a6``: ``chip_smoke.py``'s ``chunked_fold_probe`` (``log_prob`` of two
  chains the chain kernel declines, straight and over row slices: time and
  peak memory) at 2^18 and 2^20 rows, the measurement behind ROADMAP A.6;
- ``example_parts``: the ``uncertainty_and_mcmc`` example's ensemble,
  ``flow_mcmc``, ``fit_posterior`` and ``sbc_ranks``, seconds each (with
  ``--tree``, of two trees);
- ``ckpt``: the sharded checkpoints at ``chip_smoke.py``'s flagship width
  (d 32, n 8, 8 couplings of hidden 256, with a zero Adam state), each in
  fresh processes: two gloo ranks on a (1, 2) mesh, then one process
  without ``torch.distributed``. Per process the seconds of importing
  ``torch.distributed.checkpoint`` and ``torch.distributed.tensor``
  (and which of ``torch._dynamo`` / ``torch._inductor`` each step
  brought in), of building the DTensor device mesh and a first DTensor,
  of 3 calls of
  ``save_flow_orbax`` and 2 of ``load_flow_orbax``, beside 2 calls each of
  ``save_flow`` / ``load_flow`` of the same state;
- ``members``: ``train_run``'s member axis at the README / BASELINE run,
  one launch of K blocks for K in ``MEMBER_SWEEP``: ms, and from its
  ``DF_TRAIN_CLOCKS`` build every block's run time and start (its first and
  last ``%globaltimer``) and block 0's cycles of a step and an evaluation
  tile.

With ``--variants`` it builds ``csrc/step_kernels.cu`` once per setting of
its tuning switch and its per-phase clock build (``-D`` flags, into
``build/variants/``) and times each build at the shapes above, in two rounds,
each against the plain version; the clock builds give the cycles of every
phase of a tile. It also builds ``csrc/stream_kernels.cu`` with
``DF_STREAM_CLOCKS`` and splits a ``train_stream`` step at med into its
parts (cycles of block 0 per step: staging, tiles, reduction and update,
each grid barrier).

``--tree DIR`` imports the package (and ``chip_smoke.py``) from another
checkout, an earlier commit unpacked there, so that one call times two
trees with the same probes; ``--only a,b`` runs those probes alone.

With ``--check`` it first builds the five kernel sources with
``-Xptxas -v`` (registers, shared memory and spills of every kernel, printed)
and runs ``chip_smoke.py``'s checks of the chain kernels (small chains, the
wide chain at 2^16 rows, NaN and +-inf rows), of ``step_grads``,
``train_stream`` and the coupling kernels against their plain versions, and
fails on any of them: a short first call on the card for a changed kernel.

Prints one JSON object per probe and writes them all to ``--out``. Exits
non-zero without a CUDA device.
"""

import argparse
import contextlib
import hashlib
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _tree():
    """The checkout whose package the probes import: ``--tree DIR`` (an
    unpacked earlier commit, to time two trees with one script), else the
    one holding this script."""
    if "--tree" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TREE = _tree()
sys.path.insert(0, TREE)

import densityflows_tpu_torch as dt  # noqa: E402
from densityflows_tpu_torch.models import fused_chain as fc  # noqa: E402
from densityflows_tpu_torch.models import fused_train as ft  # noqa: E402
from densityflows_tpu_torch.ops import chain_kernels as ck  # noqa: E402
from densityflows_tpu_torch.ops import coupling_kernels as cpk  # noqa: E402
from densityflows_tpu_torch.ops import stream_kernels as stk  # noqa: E402
from densityflows_tpu_torch.ops import train_kernels as tk  # noqa: E402

SEED = 0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, warmup=3, runs=15):
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
    """Device time per call of each kernel ``fn`` launches, from
    torch.profiler (``None`` where the profiler shows no device time)."""
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
            out[ev.key] = t / 1e3 / calls
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


def sass_mix(lib_glob, kernel):
    """Opcode counts of one kernel's SASS in a built library (cuobjdump)."""
    import glob
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(glob.glob(lib_glob))
    if not libs or not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", libs[-1]], capture_output=True,
                          text=True).stdout
    out, on = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            on = kernel in line
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if on and m:
            op = m.group(2).split(".")[0]
            out[op] = out.get(op, 0) + 1
    return out


def put(a, device):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


# -- chain_nan ----------------------------------------------------------------

def nan_chain(d, n, h, device, rng):
    """Relu couplings (two and three dense layers, one without bias) and a
    trailing LogitLayer over (-60, 60)."""
    lo, hi = list(range(d // 2)), list(range(d // 2, d))
    kw = dict(n=n, device=device, hidden_dim_s=h, hidden_dim_t=h,
              activation_s="relu", activation_t="relu")
    chain = dt.flow_chain(
        dt.coupling_layer(d, lo, n_sublayers_s=2, n_sublayers_t=2, **kw),
        dt.coupling_layer(d, hi, bias=False, **kw),
        dt.coupling_layer(d, lo, **kw),
        dt.logit_layer((np.full(d, -60.0, np.float32),
                        np.full(d, 60.0, np.float32)), device=device))
    with torch.no_grad():
        for p in chain.parameters():
            p.copy_(put(rng.uniform(-0.4, 0.4, size=tuple(p.shape)), device))
    return chain


def nan_mismatch(got, want):
    return int((torch.isnan(got) != torch.isnan(want)).sum())


def chain_nan(device):
    rng = np.random.default_rng(SEED + 21)
    d, n, rows = 7, 3, 257
    chain = nan_chain(d, n, 18, device, rng)
    x = put(rng.uniform(-5, 5, size=(rows, d)), device)
    th = put(rng.uniform(size=(rows, n)), device)
    x[3, 1] = float("nan")           # a transformed / identity dim
    th[11, 0] = float("nan")         # a condition: through relu only
    out = {}
    for dirn in ("fwd", "inv"):
        plan, params = fc._plan_params(chain, dirn)
        want_y, want_l = ck.chain_apply_plain(plan, params, x, th,
                                              with_ldj=True)
        y, ldj = ck.run_chain(plan, params, x, th, with_ldj=True)
        torch.cuda.synchronize()
        out[f"chain_apply_{dirn}"] = dict(
            y_nan_mismatch=nan_mismatch(y, want_y),
            ldj_nan_mismatch=nan_mismatch(ldj, want_l),
            plain_nan_rows=int(torch.isnan(want_l).sum()),
            kernel_nan_rows=int(torch.isnan(ldj).sum()))
    plan, params = fc._plan_params(chain, "fwd")
    y, r = ck.run_chain_sample(plan, params, rows, d, th, seed=5,
                               return_noise=True)
    torch.cuda.synchronize()
    want = ck.chain_sample_plain(plan, params, rows, d, th, noise=r)
    out["chain_sample"] = dict(y_nan_mismatch=nan_mismatch(y, want),
                               plain_nan_entries=int(torch.isnan(want).sum()),
                               kernel_nan_entries=int(torch.isnan(y).sum()))
    return out


# -- step_host ----------------------------------------------------------------

def step_flow(kind, device):
    rng = np.random.default_rng(SEED)
    if kind == "med":
        d, n, h = 16, 4, 64
        kw = dict(n=n, hidden_dim_s=h, hidden_dim_t=h, device=device)
        layers = [dt.coupling_layer(d, list(range(d // 2)), **kw),
                  dt.coupling_layer(d, list(range(d // 2, d)), **kw),
                  dt.coupling_layer(d, list(range(d // 2)), **kw)]
    else:
        d, n = 5, 1
        kw = dict(n=n, hidden_dim_s=16, hidden_dim_t=16, device=device)
        layers = [dt.coupling_layer(d, [0, 1, 2], **kw),
                  dt.coupling_layer(d, [2, 3, 4], **kw),
                  dt.coupling_layer(d, [4, 0, 1], **kw)]
    x_ref = rng.normal(size=(256, d)).astype(np.float32)
    chain = dt.flow_chain(*layers, dt.normalization_layer(
        x_ref, -1.0, 1.0, device=device))
    with torch.no_grad():
        for p in chain.parameters():
            p.copy_(put(rng.uniform(-0.2, 0.2, size=tuple(p.shape)), device))
    meta = dt.MetaData(kind, d, n, np.zeros(n), np.ones(n))
    return dt.Flow(chain, meta, device=device), d, n


def step_host(device):
    out = {}
    for kind, batch in (("med", 1024), ("baseline", 64)):
        flow, d, n = step_flow(kind, device)
        folded = ft.fold_for_step(flow)
        sp = folded.step_plan
        flat = sp.flatten(folded.tparams)
        rng = np.random.default_rng(SEED + 3)
        x = put(rng.normal(size=(batch, d)) * 0.5, device)
        th = put(rng.uniform(size=(batch, n)), device)
        mask = torch.ones(batch, device=device)
        denom = mask.sum()

        def call():
            return sp.loss_and_grads(flat, x, th, mask, denom=denom)

        call_ms = event_ms(call)
        reps = 200
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host = (time.perf_counter() - t0) / reps
        e1.record()
        torch.cuda.synchronize()
        out[kind] = dict(
            batch=batch, folded_parameters=sp.n_params, call_ms=call_ms,
            host_enqueue_ms=1e3 * host,
            back_to_back_ms=e0.elapsed_time(e1) / reps,
            device_ms_by_kernel=device_ms_by_kernel(call))
    return out


# -- coupling -----------------------------------------------------------------

def coupling_case(device):
    """One coupling of the opt-in train step's shape (8192 rows, K 24, A 16,
    hidden 256, three dense layers per net, relu) and its cotangents."""
    rng = np.random.default_rng(SEED + 17)
    B, K, A, H = 8192, 24, 16, 256

    def net():
        dims = [K, H, H, A]
        ws = [put(rng.uniform(-1, 1, size=(a, b)) * np.sqrt(6 / (a + b)) *
                  (0.3 if i == 2 else 1), device)
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
        bs = [put(rng.normal(size=b) * 0.05, device) for b in dims[1:]]
        return ws, bs, "relu"

    s, t = net(), net()
    return s, t, *(put(rng.normal(size=shape), device)
                   for shape in ((B, K), (B, A), (B, A), (B,)))


def coupling(device):
    s, t, h, y, gy, gl = coupling_case(device)

    def bwd():
        return cpk.coupling_bwd(s, t, h, y, gy, gl, direction="inverse")

    def transposes():
        return [w.t().contiguous() for w in s[0] + t[0]]

    def fwd():
        return cpk.coupling_fwd(s, t, h, y, direction="inverse")

    B, K = h.shape
    # a tree from before the backward's redesign has no bwd_launches
    per_call = (cpk.bwd_launches(s, t) + 1
                if hasattr(cpk, "bwd_launches") else 2)
    # the forward's host enqueue per call, over back-to-back calls
    for _ in range(5):
        fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fwd()
    fwd_host_ms = 1e3 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    return dict(rows=B, K=K, A=y.shape[1], hidden=s[0][0].shape[1],
                coupling_fwd_host_enqueue_ms=fwd_host_ms,
                coupling_bwd_call_ms=event_ms(bwd),
                coupling_bwd_device_ms_by_launch=launch_ms(bwd, per_call),
                coupling_bwd_device_ms_by_kernel=device_ms_by_kernel(bwd),
                coupling_fwd_call_ms=event_ms(fwd),
                coupling_fwd_device_ms=device_ms_by_kernel(fwd),
                six_transposes_ms=event_ms(transposes),
                six_transposes_device_ms=device_ms_by_kernel(transposes))


# -- stream: train_stream at med, its clock split, and at BASELINE -------------

def med_case(device):
    """The train_stream main path's shapes (``chip_smoke.py`` "med": d 16,
    n 4, hidden 64, batch 1024, the 2^20 rows split 0.9 / 0.1) and the
    permutation of its first epoch: ``(head, sp, n_batches)``."""
    import chip_smoke as cs

    x, th, _, _ = cs.med_data(np.random.default_rng(SEED))
    dataset = dt.DataArrays.make(x, th, rng=0)
    flow = cs.med_flow(x[:256], th, device, SEED)
    sp = ft.fold_for_step(flow).step_plan
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(flow.model)
    xt, tht = (put(a, device) for a in
               dataset.normalized_training_data(flow.metadata))
    n_train = xt.shape[0]
    perms = ft.draw_epoch_perms(torch.Generator().manual_seed(SEED + 7), 1,
                                n_train)
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros, xt, tht,
            perms)
    return head, sp, -(-n_train // 1024)


def stream_bits(out):
    """sha256 of one run's per-step losses and snapshots (the bits that two
    trees must share)."""
    h = hashlib.sha256()
    for t in [out[5]] + list(out[3]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# csrc/stream_kernels.cu's CK_* slots before CK_STEPS, in order
STREAM_CLOCK_SLOTS = (
    "denominator", "stage_parameters", "tiles", "sync_tiles", "reduce",
    "sync_reduce", "update", "sync_update", "w_items", "sync_w_items",
    "tile_products", "products_wait", "products_split", "products_mma",
    "w_items_wait", "w_items_split", "w_items_mma")


def stream(device, clocks_lib=None):
    """One epoch of train_stream at med (922 steps): ms per epoch and per
    step (CUDA events), the launch shape, the sha256 of its per-step losses
    and snapshots; with ``clocks_lib`` (the DF_STREAM_CLOCKS build) the
    cycles of each part of a step on block 0, per step. Then the BASELINE
    config (datatest.npz, three couplings of hidden 16, batch 64): 50 epochs
    of train_stream beside train_run on the same permutations."""
    import chip_smoke as cs

    head, sp, n_batches = med_case(device)

    def kernel(**kw):
        return stk.run_fused_train_stream(*head, batchsize=1024, step_plan=sp,
                                          with_losses=True, **kw)

    out = kernel()
    torch.cuda.synchronize()
    ms = event_ms(kernel, warmup=1, runs=3)
    shape = stk.device_launch_shape(sp, 1024)
    row = dict(folded_parameters=sp.n_params, steps=n_batches,
               ms_per_epoch=ms, ms_per_step=ms / n_batches,
               launch_shape=dict(zip(("tile", "threads", "shared_bytes",
                                      "blocks"), shape)),
               losses_and_snapshots_sha256=stream_bits(out),
               final_loss=float(out[5][-1]))
    if clocks_lib is not None:
        use_stream_library(clocks_lib)
        clk = torch.zeros(32, device=device)
        kernel(clocks=clk)
        torch.cuda.synchronize()
        c = clk.tolist()
        steps = c[len(STREAM_CLOCK_SLOTS)]
        names = STREAM_CLOCK_SLOTS
        per_step = {k: c[i] / steps for i, k in enumerate(names)}
        total = sum(per_step.values())
        ms_clk = event_ms(lambda: kernel(clocks=clk), warmup=1, runs=3)
        row["clocks"] = dict(
            steps=steps, cycles_per_step=per_step,
            total_cycles_per_step=total,
            share=({k: v / total for k, v in per_step.items()}
                   if total else None),
            clock_build_ms_per_step=ms_clk / n_batches,
            cycles_per_us=total / (1e3 * ms_clk / n_batches))
        stk._LIB = None
        stk._library()

    data_b, dat = cs.baseline_data()
    flow = cs.baseline_flow(data_b, dat, device, SEED)
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(flow.model)
    xt, tht = data_b.normalized_training_data(flow.metadata)
    xv, thv = data_b.normalized_validation_data(flow.metadata)
    xt, tht, xv, thv = (put(a, device) for a in (xt, tht, xv, thv))
    perms = np.stack([np.random.default_rng(SEED + i).permutation(
        xt.shape[0]) for i in range(50)])
    zeros = [torch.zeros_like(p) for p in tparams]
    bhead = (plan, tparams, masks, slots, cparams, zeros, zeros)
    run_ms = event_ms(lambda: tk.run_fused_train(
        *bhead, xt, tht, xv, thv, perms, batchsize=64), warmup=1, runs=5)
    stream_ms = event_ms(lambda: stk.run_fused_train_stream(
        *bhead, xt, tht, perms, batchsize=64), warmup=1, runs=5)
    b_shape = stk.device_launch_shape(
        ft.fold_for_step(flow).step_plan, 64)
    row["baseline_50_epochs"] = dict(
        train_rows=int(xt.shape[0]), batch=64,
        steps=50 * -(-xt.shape[0] // 64), train_run_ms=run_ms,
        train_stream_ms=stream_ms,
        train_stream_launch_shape=dict(zip(("tile", "threads",
                                            "shared_bytes", "blocks"),
                                           b_shape)))
    return row


# -- train: train_run at BASELINE, its clock split, the routing crossover -----

def baseline_case(device, epochs=50):
    """The README / BASELINE config (datatest.npz, three couplings of
    hidden 16, batch 64) folded for the kernels, and ``epochs`` batch
    orders: ``(flow, head, arrays, perms)``."""
    import chip_smoke as cs

    data_b, dat = cs.baseline_data()
    flow = cs.baseline_flow(data_b, dat, device, SEED)
    (plan, _tc, tparams, masks, slots, cparams, _f, _u) = \
        ft.chain_train_fold(flow.model)
    xt, tht = data_b.normalized_training_data(flow.metadata)
    xv, thv = data_b.normalized_validation_data(flow.metadata)
    arrays = tuple(put(a, device) for a in (xt, tht, xv, thv))
    perms = np.stack([np.random.default_rng(SEED + i).permutation(
        xt.shape[0]) for i in range(epochs)])
    zeros = [torch.zeros_like(p) for p in tparams]
    head = (plan, tparams, masks, slots, cparams, zeros, zeros)
    return flow, head, arrays, perms


def run_bits(out):
    """sha256 of a train_run result: parameters, moments, both histories."""
    h = hashlib.sha256()
    for t in list(out[0]) + list(out[1]) + list(out[2]) + [out[3], out[4]]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_phase_names(packed):
    """Names of the phases of one step and of one evaluation tile, in the
    order the DF_TRAIN_CLOCKS build records them: the tree's own
    (``train_kernels.run_phase_names``), or the layout of the design before
    it (one phase per instruction)."""
    if hasattr(tk, "run_phase_names"):
        return tk.run_phase_names(packed)
    prog = packed.prog.tolist()
    fwd = [OPCODES[prog[32 + 16 * k]] for k in range(packed.n_fwd)]
    bwd = [OPCODES[prog[32 + 16 * (packed.n_fwd + k)]]
           for k in range(packed.n_bwd)]
    step = (["load_batch"] + fwd + ["row_log_prob", "batch_loss",
                                    "loss_cotangents"] + bwd
            + ["mask_and_check", "adam_update"])
    return step, ["load_rows"] + fwd + ["row_log_prob", "eval_accumulate"]


def members_launcher(lib, clk=None, stamps=None):
    """``launch(ptrs, iargs, fargs, members, threads, shared)`` for
    ``tk._train_run_members``: ``lib``'s df_train_run_members on the current
    stream, with the DF_TRAIN_CLOCKS build's clock buffer ``clk`` and
    per-block timestamps ``stamps`` (or null) appended when ``clk`` is
    given."""
    import ctypes

    i, v = ctypes.c_int, ctypes.c_void_p
    lib.df_train_run_members.restype = i
    stream = torch.cuda.current_stream().cuda_stream

    def launch(ptrs, iargs, fargs, members, threads, shared):
        if clk is not None:
            ptrs = (ctypes.c_void_p * (len(ptrs) + 2))(
                *ptrs, clk.data_ptr(),
                stamps.data_ptr() if stamps is not None else None)
        return lib.df_train_run_members(ptrs, iargs, fargs, i(members),
                                        i(threads), i(shared), v(stream))
    return launch


def train_one(launch, head, arrays, perms, **kw):
    """One run of the BASELINE ``head`` through ``launch``: a launch of one
    member."""
    plan, tparams, masks, slots, cparams, mu, nu = head
    return tk._train_run_members(launch, plan, [tparams], masks, slots,
                                 cparams, [mu], [nu], *arrays, [perms],
                                 **kw)[0]


def train_clocks(device, lib, head, arrays, perms, packed):
    """The DF_TRAIN_CLOCKS build of csrc/train_kernels.cu (``lib``) on the
    BASELINE run: cycles of each phase of one step and of one evaluation
    tile, by phase and summed by kind, the median of three launches."""
    clk = torch.zeros(2 + 2 * 256, device=device)
    launch = members_launcher(lib, clk)   # no per-block timestamps
    kw = dict(batchsize=64, count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              track_best=False, w=None, w_valid=None, guard_nonfinite=False,
              packed=packed, threads=None)
    runs = []
    for _ in range(3):
        clk.zero_()
        train_one(launch, head, arrays, perms, **kw)
        torch.cuda.synchronize()
        runs.append(clk.tolist())
    step_names, eval_names = run_phase_names(packed)
    out = {}
    for slot, names in ((0, step_names), (1, eval_names)):
        n = int(runs[0][slot])
        cycles = [statistics.median(r[2 + 256 * slot + k] for r in runs)
                  for k in range(n)]
        by_kind = {}
        for name, c in zip(names, cycles):
            by_kind[name] = by_kind.get(name, 0.0) + c
        out["step" if slot == 0 else "eval_tile"] = dict(
            phases=n, names_match=len(names) == n,
            total_cycles=sum(cycles),
            cycles_per_phase=sum(cycles) / n if n else None,
            cycles_by_kind=by_kind, cycles_by_phase=list(zip(names, cycles)))
    ms_clk = event_ms(lambda: train_one(launch, head, arrays, perms, **kw),
                      warmup=1, runs=3)
    out["clock_build_ms"] = ms_clk
    return out


def build_one(src, tag, flags):
    """One variant library of the tree's ``csrc/<src>.cu``."""
    import ctypes

    from densityflows_tpu_torch import _build

    out_dir = os.path.join(_build.build_dir(), "variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{src}_{tag}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
           _build.source_path(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {tag}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(so)


def train(device, clocks=False):
    """train_run at the README / BASELINE config for 50 epochs: CUDA-event
    ms at the default thread count and at 512 and 1024, the launch shape
    (threads, shared bytes, phases), the sha256 of two launches' results
    (they must be equal), the final validation NLL; then the routing
    crossover: ``train_stream`` on the same 50 epochs plus its
    ``eval_snapshots`` of both splits, the evaluation the resident kernel
    does inside. With ``clocks`` (``--variants``) also the DF_TRAIN_CLOCKS
    build's split of one step and one evaluation tile."""
    flow, head, arrays, perms = baseline_case(device)
    xt, tht, xv, thv = arrays
    packed = tk.pack_train_plan(*head[:5], xt.shape[1], tht.shape[1], 64)

    def run(threads=None):
        kw = dict(batchsize=64, count0=0, lr=1e-3, b1=0.9, b2=0.999,
                  eps=1e-8, track_best=False, w=None, w_valid=None,
                  guard_nonfinite=False, packed=packed)
        return train_one(members_launcher(tk._library()), head, arrays,
                         perms, threads=threads, **kw)

    a, b = run(), run()
    torch.cuda.synchronize()
    row = dict(epochs=50, train_rows=int(xt.shape[0]), batch=64,
               steps=50 * -(-xt.shape[0] // 64),
               shared_bytes=packed.shared_bytes,
               default_threads=tk._block_threads(packed),
               ms=event_ms(run, warmup=1, runs=5),
               ms_by_threads={t: event_ms(lambda: run(t), warmup=1, runs=3)
                              for t in (256, 512)},
               two_launches_same_bits=run_bits(a) == run_bits(b),
               sha256=run_bits(a),
               final_valid_nll=float(a[4][-1]),
               final_train_nll=float(a[3][-1]))
    if hasattr(tk, "run_layout"):
        row["layout"] = tk.run_layout(packed)

    # the crossover: train_stream over the same 50 epochs, then the
    # evaluation of each epoch's snapshot on both splits
    sp = ft.fold_for_step(flow).step_plan

    def stream_run():
        p, _m, _n, snaps, _s = stk.run_fused_train_stream(
            *head, xt, tht, perms, batchsize=64, step_plan=sp)
        tl = stk.eval_snapshots(snaps, sp.cparams, xt, tht, None,
                                plan=sp.plan)
        vl = stk.eval_snapshots(snaps, sp.cparams, xv, thv, None,
                                plan=sp.plan)
        return p, tl, vl

    stream_kernel_ms = event_ms(lambda: stk.run_fused_train_stream(
        *head, xt, tht, perms, batchsize=64, step_plan=sp), warmup=1, runs=5)
    stream_total_ms = event_ms(stream_run, warmup=1, runs=3)
    _p, _tl, vl = stream_run()
    row["crossover"] = dict(
        train_run_ms=row["ms"], train_stream_kernel_ms=stream_kernel_ms,
        train_stream_with_eval_snapshots_ms=stream_total_ms,
        eval_snapshots_ms=stream_total_ms - stream_kernel_ms,
        train_stream_final_valid_nll=float(vl[-1]))
    if clocks:
        lib = build_one("train_kernels", "clocks", ["-DDF_TRAIN_CLOCKS=1"])
        row["clocks"] = train_clocks(device, lib, head, arrays, perms,
                                     packed)
    return row


def members(device):
    """train_run's member axis at the BASELINE run (50 epochs): one launch
    of K blocks for K in MEMBER_SWEEP, CUDA-event ms, and from the
    DF_TRAIN_CLOCKS build block 0's cycles of one step and of one
    evaluation tile plus every block's first and last %globaltimer: how
    long each block ran, how far apart the blocks started, and the clock
    rate block 0 saw (its step's cycles over its step's share of its
    time)."""
    flow, head, arrays, perms = baseline_case(device)
    xt, tht = arrays[0], arrays[1]
    packed = tk.pack_train_plan(*head[:5], xt.shape[1], tht.shape[1], 64)
    lib = build_one("train_kernels", "clocks", ["-DDF_TRAIN_CLOCKS=1"])
    steps = perms.shape[0] * -(-xt.shape[0] // 64)
    kw = dict(batchsize=64, count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              track_best=False, w=None, w_valid=None, guard_nonfinite=False,
              packed=packed, threads=None)
    out = dict(steps=steps, shared_bytes=packed.shared_bytes,
               threads=tk._block_threads(packed), by_members={})
    for k in MEMBER_SWEEP:
        clk = torch.zeros(2 + 2 * 256, device=device)
        stamps = torch.zeros(2 * k, dtype=torch.int64, device=device)

        launch = members_launcher(lib, clk, stamps)
        tps = [head[1]] * k
        zs = [head[5]] * k
        pm = [perms] * k
        run = lambda: tk._train_run_members(  # noqa: E731
            launch, head[0], tps, head[2], head[3], head[4], zs, zs,
            *arrays, pm, **kw)
        fused_ms = event_ms(lambda: tk.run_fused_train_members(
            head[0], tps, head[2], head[3], head[4], zs, zs, *arrays, pm,
            batchsize=64, packed=packed), warmup=1, runs=3)
        run()
        torch.cuda.synchronize()
        t = stamps.view(k, 2).cpu().numpy().astype(np.float64)
        dur_ms = (t[:, 1] - t[:, 0]) / 1e6
        step_cycles = sum(clk[2:2 + int(clk[0])].tolist())
        row = dict(
            ms=fused_ms, clock_build_ms=event_ms(run, warmup=0, runs=2),
            block_ms_min=float(dur_ms.min()),
            block_ms_median=float(np.median(dur_ms)),
            block_ms_max=float(dur_ms.max()),
            start_spread_ms=float((t[:, 0].max() - t[:, 0].min()) / 1e6),
            block0_step_cycles=step_cycles,
            block0_eval_tile_cycles=sum(
                clk[2 + 256:2 + 256 + int(clk[1])].tolist()))
        # block 0 ran ``steps`` steps and the evaluations in dur_ms[0]
        row["block0_cycles_per_ns_if_steps_only"] = (
            step_cycles * steps / (dur_ms[0] * 1e6))
        out["by_members"][k] = row
        print(json.dumps({"members": k, **row}), flush=True)
    return out


MEMBER_SWEEP = (1, 2, 4, 8, 16, 32, 132)


def train_variants(device):
    """train_run's layouts timed in turns at the BASELINE run: the s- and
    t-nets paired or not, the gradients summed in 4 or 1 segments of rows,
    at 256 and 512 threads; with each, the DF_TRAIN_CLOCKS build's cycles
    of a step and of an evaluation tile. (The dense handlers of
    flow_phases.cuh and a bound of 1,024 threads, timed here before they
    were removed, are reached with ``--tree`` on an older commit.)"""
    from concurrent.futures import ThreadPoolExecutor

    if not hasattr(tk, "run_layout"):
        return None
    flow, head, arrays, perms = baseline_case(device)
    xt, tht = arrays[0], arrays[1]
    jobs = [("variants", []), ("variants_clocks", ["-DDF_TRAIN_CLOCKS=1"])]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        libs = dict(zip([j[0] for j in jobs], pool.map(
            lambda j: build_one("train_kernels", j[0], j[1]), jobs)))
    kw = dict(batchsize=64, count0=0, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
              track_best=False, w=None, w_valid=None, guard_nonfinite=False)
    grid = [(True, 4), (True, 1), (False, 4), (False, 1)]
    out = []
    for rnd in range(2):
        for paired, segs in grid:
            packed = tk.pack_train_plan(*head[:5], xt.shape[1], tht.shape[1],
                                        64, paired=paired,
                                        grad_segments=segs)
            row = dict(round=rnd, paired=paired, grad_segments=segs,
                       eval_rows=packed.eval_rows)
            for threads in (256, 512):
                row[f"ms_{threads}"] = event_ms(
                    lambda: train_one(
                        members_launcher(libs["variants"]), head, arrays,
                        perms, packed=packed, threads=threads, **kw),
                    warmup=1, runs=3)
            if rnd == 0:
                clk = torch.zeros(2 + 2 * 256, device=device)
                train_one(members_launcher(libs["variants_clocks"], clk),
                          head, arrays, perms, packed=packed, threads=512,
                          **kw)
                torch.cuda.synchronize()
                c = clk.tolist()
                step = c[2:2 + int(c[0])]
                tile = c[2 + 256:2 + 256 + int(c[1])]
                row.update(step_phases=len(step), step_cycles=sum(step),
                           tile_phases=len(tile), tile_cycles=sum(tile),
                           step_by_phase=[round(x) for x in step],
                           tile_by_phase=[round(x) for x in tile])
            out.append(row)
            print(json.dumps({"train_variant": row}), flush=True)
    return out


def use_stream_library(lib):
    """Point the train_stream wrapper at ``lib`` (argtypes as its _library
    sets)."""
    import ctypes

    i, v = ctypes.c_int, ctypes.c_void_p
    lib.df_train_stream.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), i, i, i, v]
    lib.df_train_stream.restype = i
    lib.df_train_stream_max_blocks.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.df_train_stream_max_blocks.restype = i
    stk._LIB = lib


# -- chain: chain_apply / chain_sample at the serving main path's shape --------

def chain(device):
    """chain_apply (inverse with ldj) and chain_sample on the wide split
    chain (d 32, n 8, 8 couplings of hidden 256) at 2^18 rows: CUDA-event ms
    and torch.profiler device ms, at every row tile the wrapper offers."""
    import chip_smoke as cs

    rng = np.random.default_rng(SEED + 5)
    chain_ = cs.wide_chain(False, rng, device)
    rows = 1 << 18
    x, th = cs.data(rng, rows, 32, 8, device)
    th1 = th[:1].contiguous()
    plan, params = fc._plan_params(chain_, "inv")
    packed = ck.pack_plan(plan, params, 32, 8)
    plan_f, params_f = fc._plan_params(chain_, "fwd")
    packed_f = ck.pack_plan(plan_f, params_f, 32, 8)
    want = ck.chain_apply_plain(plan, params, x, th, with_ldj=True)
    out = {"default_tile_rows": ck.pick_tile_rows(32, 8, packed.ldh)}
    for tb in ck.TILE_ROWS:
        try:
            ck._tile_rows(tb, 32, 8, packed.ldh)
        except ValueError as e:
            out[f"tile_{tb}"] = str(e)
            continue

        def apply():
            return ck.run_chain(plan, params, x, th, with_ldj=True,
                                packed=packed, tile_rows=tb)

        def sample():
            return ck.run_chain_sample(plan_f, params_f, rows, 32, th1,
                                       seed=7, packed=packed_f, tile_rows=tb)

        y, ldj = apply()
        torch.cuda.synchronize()
        out[f"tile_{tb}"] = dict(
            chain_apply_ms=event_ms(apply, runs=9),
            chain_apply_device_ms=device_ms_by_kernel(apply, calls=5),
            chain_sample_ms=event_ms(sample, runs=9),
            chain_sample_device_ms=device_ms_by_kernel(sample, calls=5),
            y_max_abs_err=float((y - want[0]).abs().max()),
            ldj_max_abs_err=float((ldj - want[1]).abs().max()))
    return out


STEP_VARIANTS = {
    "default": [],
    "flat": ["-DDF_STEP_TILED=0"],
    "clocks": ["-DDF_STEP_CLOCKS=1"],
    "flat_clocks": ["-DDF_STEP_TILED=0", "-DDF_STEP_CLOCKS=1"],
}
OPCODES = ["f_dense", "f_couple", "f_anorm", "f_affine", "b_couple",
           "b_dense", "b_anorm", "b_affine"]
def build_variants():
    """Every variant's library: {(source, tag): ctypes.CDLL}, built in
    parallel with the package's nvcc flags and the variant's."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = [("step_kernels", tag, flags)
            for tag, flags in STEP_VARIANTS.items()]
    jobs.append(("stream_kernels", "clocks", ["-DDF_STREAM_CLOCKS=1"]))
    jobs.append(("chain_kernels", "clocks", ["-DDF_CHAIN_CLOCKS=1"]))
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(zip([j[:2] for j in jobs],
                        pool.map(lambda j: build_one(*j), jobs)))


def use_chain_library(lib):
    """Point the chain wrappers at ``lib`` (argtypes as its _library sets)."""
    import ctypes

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.df_chain_apply.argtypes = [p, p, p, p, p, i, p, p, ll, i, i, i, i, p]
    lib.df_chain_apply.restype = i
    lib.df_chain_sample.argtypes = [p, p, p, i, p, i, p, p, ll, i, i, i,
                                    ctypes.c_uint, ctypes.c_uint, ll, i, p]
    lib.df_chain_sample.restype = i
    lib.df_chain_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.df_chain_clocks.restype = i
    ck._LIB = lib


def chain_clocks(device, lib):
    """The DF_CHAIN_CLOCKS build of csrc/chain_kernels.cu (``lib``) on the
    serving shape (the wide split chain, inverse with ldj, 2^18 rows): the
    cycles of block 0's fold by part, at each row tile."""
    import ctypes

    import chip_smoke as cs

    rng = np.random.default_rng(SEED + 5)
    chain_ = cs.wide_chain(False, rng, device)
    x, th = cs.data(rng, 1 << 18, 32, 8, device)
    plan, params = fc._plan_params(chain_, "inv")
    packed = ck.pack_plan(plan, params, 32, 8)
    use_chain_library(lib)
    names = ("consumer_full_wait", "consumer_products", "consumer_epilogue",
             "consumer_other_ops", "producer_raw_wait",
             "producer_empty_wait", "producer_split")
    out = {}
    for tb in ck.TILE_ROWS:
        ck.run_chain(plan, params, x, th, with_ldj=True, packed=packed,
                     tile_rows=tb)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        if lib.df_chain_clocks(buf) != 0:
            out = None
            break
        vals = [int(buf[i]) for i in range(len(names))]
        out[f"tile_{tb}"] = dict(zip(names, vals),
                                 consumer_total=sum(vals[:4]),
                                 producer_total=sum(vals[4:]))
    ck._LIB = None
    return out


def use_library(lib):
    """Point the step wrapper at ``lib`` (argtypes as its _library sets)."""
    import ctypes

    from densityflows_tpu_torch.ops import step_kernels as sk

    i, v = ctypes.c_int, ctypes.c_void_p
    lib.df_step_grads.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        i, i, i, v]
    lib.df_step_grads.restype = i
    sk._LIB = lib


def phase_clocks(sp, flat, x, th, mask, den):
    """The DF_STEP_CLOCKS build's cycles per phase of block 0's tile, in
    phase order, named by the instruction each phase runs; the median of
    five launches."""
    from densityflows_tpu_torch.ops import step_kernels as sk

    launcher = sp.launcher(x.shape[0])
    prog = launcher.packed.prog.tolist()
    n_fwd, n_bwd = launcher.packed.n_fwd, launcher.packed.n_bwd
    names = (["stage"] if launcher.staged else []) + ["load_rows"] + [
        OPCODES[prog[32 + 16 * k]] for k in range(n_fwd)] + [
        "row_log_prob", "loss"] + [
        OPCODES[prog[32 + 16 * (n_fwd + k)]] for k in range(n_bwd)]
    runs = []
    for _ in range(5):
        buf = torch.zeros(sp.n_params + 1, device=x.device)
        launcher(sk._library_launch, flat, x, th, mask, denom=den, out=buf,
                 phases=1)
        torch.cuda.synchronize()
        runs.append(buf[:len(names)].tolist())
    cycles = [statistics.median(r[i] for r in runs)
              for i in range(len(names))]
    by_op = {}
    for name, c in zip(names, cycles):
        by_op[name] = by_op.get(name, 0.0) + c
    return dict(tile=launcher.tile, threads=launcher.threads,
                staged=launcher.staged, total_cycles=sum(cycles),
                cycles_by_instruction=by_op,
                cycles_by_phase=list(zip(names, cycles)))


def step_times(device, clocks=False):
    """step_grads at the med and batch-64 shapes: error against the plain
    version, call time, device time (all kernels); with ``clocks`` the
    cycles of each phase instead (the DF_STEP_CLOCKS build)."""
    from densityflows_tpu_torch.ops import step_kernels as sk

    row = {}
    for kind, batch in (("med", 1024), ("baseline", 64)):
        flow, d, n = step_flow(kind, device)
        folded = ft.fold_for_step(flow)
        sp = folded.step_plan
        flat = sp.flatten(folded.tparams)
        rng = np.random.default_rng(SEED + 3)
        x = put(rng.normal(size=(batch, d)) * 0.5, device)
        th = put(rng.uniform(size=(batch, n)), device)
        mask = torch.ones(batch, device=device)
        den = mask.sum().reshape(1)

        def call():
            return sp.loss_and_grads(flat, x, th, mask, denom=den)

        if clocks:
            row[kind] = phase_clocks(sp, flat, x, th, mask, den)
            continue
        loss, grads = sk.step_grads_plain(sp.plan, folded.tparams, sp.masks,
                                          sp.mask_slots, sp.cparams, x, th,
                                          mask)
        want = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        kernels = device_ms_by_kernel(call)
        row[kind] = dict(max_abs_err=float((call() - want).abs().max()),
                         call_ms=event_ms(call),
                         device_ms=sum(kernels.values()) if kernels else None)
    return row


def variants(device):
    libs = build_variants()
    out = {"chain_clocks": chain_clocks(device, libs["chain_kernels",
                                                     "clocks"])}
    print(json.dumps({"chain_clocks": out["chain_clocks"]}), flush=True)
    out["stream_clocks"] = stream(device, libs["stream_kernels", "clocks"])
    print(json.dumps({"stream_clocks": out["stream_clocks"]}), flush=True)
    for rnd in range(2):
        for tag in STEP_VARIANTS:
            clocks = tag.endswith("clocks")
            if clocks and rnd:
                continue
            use_library(libs["step_kernels", tag])
            out.setdefault(tag, []).append(step_times(device, clocks=clocks))
        print(json.dumps({"variants_round": rnd, **out}), flush=True)
    return out


def families(device):
    """``chip_smoke.py``'s five phases of the families without a kernel
    (other bases, spline, MAF / IAF, embedding, the spline + RealNVP train
    step), each printing its own line: seconds per phase."""
    import tempfile

    import chip_smoke as cs
    from densityflows_tpu_torch import _build

    _build.load_libraries(["chain_kernels", "coupling_kernels"])
    card = card_line()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("bases", lambda: cs.drive_bases(device, tmp, card)),
                ("rqs", lambda: cs.drive_rqs(device, card)),
                ("maf", lambda: cs.drive_maf(device, card)),
                ("embed", lambda: cs.drive_embed(device, card)),
                ("mixed", lambda: cs.drive_mixed_coupling(device, card))):
            t0 = time.time()
            fn()
            out[f"{name}_seconds"] = time.time() - t0
    return out


def example_parts(device):
    """The ``uncertainty_and_mcmc`` example's four parts at its own budgets,
    each timed by the host clock after a synchronisation: the 5-member
    ensemble (40 epochs, the plain program), ``flow_mcmc`` (256 chains, 800
    steps), ``fit_posterior`` (60 epochs) and ``sbc_ranks``, seconds each."""
    import warnings

    from densityflows_tpu_torch.examples.uncertainty_and_mcmc import (
        make_target_data,
        target_logp,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rng = np.random.default_rng(0)
    x = make_target_data(rng, 4000)
    data = dt.DataArrays.make(x, rng=0)

    def factory(generator):
        kw = dict(hidden_dim_s=64, hidden_dim_t=64, device=device,
                  generator=generator)
        return dt.flow_chain(
            dt.coupling_layer(2, [0], **kw),
            dt.invertible_linear_layer(
                2, generator=torch.Generator().manual_seed(7), device=device),
            dt.coupling_layer(2, [1], **kw),
            dt.actnorm_layer(x, device=device))

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ens, out["ensemble_s"] = timed(lambda: dt.train_ensemble(
            factory, data, n_members=5, epochs=40,
            generator=torch.Generator().manual_seed(1), verbose=False,
            device=device))
    member = ens.member(0)
    _, out["flow_mcmc_s"] = timed(lambda: dt.flow_mcmc(
        member, target_logp, n_chains=256, n_steps=800, burn_in=200,
        generator=torch.Generator().manual_seed(2)))
    theta = rng.normal(size=(400, 1)).astype(np.float32)
    obs = (theta + 0.3 * rng.normal(size=(400, 1))).astype(np.float32)
    post = dt.Flow(
        dt.flow_chain(dt.coupling_layer(
            1, [0], n=1, kind=dt.RQSCouplingLayer, n_bins=8,
            generator=torch.Generator().manual_seed(3), device=device)),
        dt.MetaData("", 1, 1, obs.min(0), obs.max(0)), device=device)
    _, out["fit_posterior_s"] = timed(lambda: dt.fit_posterior(
        post, theta, obs, epochs=60,
        generator=torch.Generator().manual_seed(4)))
    _, out["sbc_ranks_s"] = timed(lambda: dt.sbc_ranks(
        post, theta, obs, n_draws=128,
        generator=torch.Generator().manual_seed(5)))
    return out


def a6(device):
    """``chip_smoke.py``'s ``chunked_fold_probe`` at 2^18 and 2^20 rows: the
    measurement behind ROADMAP A.6 (the row-chunked folds)."""
    import chip_smoke as cs
    from densityflows_tpu_torch import _build

    _build.load_libraries(["chain_kernels"])
    return cs.chunked_fold_probe(device, card_line(),
                                 sizes=(cs.ROWS, 1 << 20))


def mixed_grads(device):
    """The spline + RealNVP chain of ``mixed_coupling_path``, 32 steps on
    the per-layer kernels' trajectory: at each step the largest gate ratio
    |err| / (1e-4 + 1e-4 |want|) over the loss and every gradient, of the
    kernels and of the kernels' plain versions (the hand-written pullback,
    the same f32 forward as autograd) against the plain autograd step on
    the same weights, with the leaf of the kernels' worst."""
    import chip_smoke as cs
    import densityflows_tpu_torch as dt
    from densityflows_tpu_torch import _build
    from densityflows_tpu_torch.models import fused_train as ft
    from densityflows_tpu_torch.train import _loss_and_grads

    _build.load_libraries(["coupling_kernels"])
    _, _, batches = cs.coupling_pool(device)
    model = cs.mixed_rqs_start(device)
    opt = dt.adam(1e-3)
    state = opt.init(ft.trainable_leaves(model))
    base = dt.StandardNormal(cs.D)
    mask = torch.ones(cs.COUPLING["batch"], device=device)
    rows = []
    for k in range(cs.COUPLING["steps"]):
        xb, thb = batches[k % len(batches)]
        got = {}
        for name, mode, plain in (("kernels", True, False),
                                  ("pullback", True, True),
                                  ("autograd", False, False)):
            with cs.kernel_policy(mode), (cs.plain_coupling_ops() if plain
                                          else contextlib.nullcontext()):
                got[name] = _loss_and_grads(model, base, xb, thb, mask)

        def ratios(name):
            return [cs.gate_ratio(a, b, 1e-4, 1e-4) for a, b in zip(
                [got[name][0]] + got[name][2],
                [got["autograd"][0]] + got["autograd"][2])]

        rk, rp = ratios("kernels"), ratios("pullback")
        rows.append(dict(step=k + 1, kernels=max(rk), pullback=max(rp),
                         worst=int(np.argmax(rk))))
        updates, state = opt.update(got["kernels"][2], state,
                                    got["kernels"][1])
        with torch.no_grad():
            for p, u in zip(got["kernels"][1], updates):
                p.add_(u)
    return dict(by_step=rows, kernels_max=max(r["kernels"] for r in rows),
                pullback_max=max(r["pullback"] for r in rows))


def ckpt_process(rank, world, init_file, out_dir):
    """One fresh process of the ``ckpt`` probe: rank ``rank`` of ``world``
    gloo ranks on a (1, 2) mesh, or (``world`` 1) a process without
    ``torch.distributed``. Writes ``ckpt_<world>_<rank>.json``."""
    import chip_smoke as cs

    device = torch.device("cuda")
    watched = ("torch._dynamo", "torch._inductor",
               "torch.distributed.tensor", "torch.distributed.checkpoint")

    def loaded():
        return [m for m in watched if m in sys.modules]

    out = {"rank": rank, "world": world, "loaded_at_start": loaded()}
    for name in ("checkpoint", "tensor"):
        t0 = time.perf_counter()
        importlib.import_module(f"torch.distributed.{name}")
        out[f"import_{name}_s"] = time.perf_counter() - t0
        out[f"loaded_after_{name}"] = loaded()
    from densityflows_tpu_torch.parallel.mesh import (
        _device_mesh,
        shard_params_tp,
    )
    from densityflows_tpu_torch.utils.orbax_ckpt import (
        load_flow_orbax,
        save_flow_orbax,
    )

    rng = np.random.default_rng(SEED)
    meta = cs.flagship_inputs(rng, cs.N_COND, 16, device, "ckpt")[0]
    flow = dt.Flow(cs.wide_chain(False, rng, device), meta, device=device)
    mesh = None
    if world > 1:
        dt.distributed_init(f"file://{init_file}", world, rank,
                            backend="gloo")
        mesh = dt.make_mesh((1, world), ("data", "model"))
        flow.model = shard_params_tp(mesh, flow.model)
        t0 = time.perf_counter()
        _device_mesh(mesh)
        out["device_mesh_s"] = time.perf_counter() - t0
        from torch.distributed.tensor import DTensor, Replicate, Shard

        t0 = time.perf_counter()
        DTensor.from_local(torch.zeros(2, 2), _device_mesh(mesh),
                           [Replicate(), Shard(1)], shape=(2, 4),
                           stride=(4, 1))
        out["first_dtensor_s"] = time.perf_counter() - t0
        out["loaded_after_first_dtensor"] = loaded()
    opt = dt.adam(1e-3)
    state = opt.init(ft.trainable_leaves(flow.model))
    sync = mesh.barrier if mesh is not None else (lambda: None)

    def timed(fn, calls, sync=sync):
        times = []
        for _ in range(calls):
            sync()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    sharded = os.path.join(out_dir, f"ckpt_{world}")
    gathered = os.path.join(out_dir, f"npz_{world}")
    out["save_flow_orbax_s"] = timed(
        lambda: save_flow_orbax(sharded, flow, state), 3)
    out["loaded_after_saves"] = loaded()
    out["load_flow_orbax_s"] = timed(
        lambda: load_flow_orbax(sharded, opt, mesh=mesh, device=device), 2)
    out["save_flow_s"] = timed(
        lambda: dt.save_flow(gathered, flow, state, erase=True), 2)
    if rank == 0:
        out["load_flow_s"] = timed(
            lambda: dt.load_flow(gathered, opt, device=device), 2,
            sync=lambda: None)
    sync()
    with open(os.path.join(out_dir, f"ckpt_{world}_{rank}.json"), "w") as f:
        json.dump(out, f)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


def ckpt(device):
    """The sharded checkpoints' times in fresh processes: two gloo ranks,
    then one process alone (see ``ckpt_process``)."""
    import tempfile

    result = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        for world in (2, 1):
            init = os.path.join(tmp, f"rendezvous_{world}")
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ckpt-rank",
                 str(r), str(world), init, tmp, "--tree", TREE],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(world)]
            for r, p in enumerate(procs):
                o, e = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise SystemExit(f"ckpt probe: process {r} of {world} "
                                     f"failed:\n{o[-2000:]}{e[-3000:]}")
            result[f"world_{world}"] = []
            for r in range(world):
                with open(os.path.join(tmp, f"ckpt_{world}_{r}.json")) as f:
                    result[f"world_{world}"].append(json.load(f))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/probe.json")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="import the package from this checkout instead")
    ap.add_argument("--only", default=None,
                    help="comma-separated probes to run (chain_nan, "
                         "step_host, coupling, stream, chain, train, "
                         "families, mixed_grads, members, a6, "
                         "example_parts, ckpt, variants)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = dict(card=card_line(), torch=torch.__version__,
                  cuda=torch.version.cuda, tree=TREE)
    if args.check:
        import chip_smoke as cs
        from densityflows_tpu_torch import _build

        import io

        t0 = time.time()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            _build.load_libraries(["chain_kernels", "train_kernels",
                                   "step_kernels", "stream_kernels",
                                   "coupling_kernels"], verbose=True)
        result["build_seconds"] = time.time() - t0
        # ptxas: each kernel's registers, spills and shared memory
        result["ptxas"] = [ln.strip() for ln in log.getvalue().splitlines()
                           if "Compiling entry" in ln or "Used" in ln
                           or "spill" in ln]
        print(log.getvalue(), flush=True)
        err, rows = cs.check_chain_nan(np.random.default_rng(SEED + 23),
                                       device)
        rng = np.random.default_rng(SEED)
        mixed = cs.mixed_chain(7, 3, 18, rng, device, logit=True)
        x_s, th_s = cs.data(rng, 1001, 7, 3, device)
        wide = cs.wide_chain(False, rng, device)
        x_w, th_w = cs.data(rng, 1 << 16, 32, 8, device)
        chain_errs = dict(
            apply_mixed=cs.check_apply(mixed, x_s, th_s, "mixed d7 n3 h18"),
            sample_mixed=cs.check_sample(mixed, 1001, 7, th_s,
                                         "mixed sample")[0],
            apply_wide=cs.check_apply(wide, x_w, th_w, "wide 2^16 rows"),
            sample_wide=cs.check_sample(wide, 1 << 16, 32,
                                        th_w[:1].contiguous(),
                                        "wide sample 2^16 rows")[0],
            hidden_300_520=cs.check_wide_hidden(
                np.random.default_rng(SEED + 29), device))
        stream_errs, stream_skips = cs.check_stream_small(
            np.random.default_rng(SEED), device)
        result["check"] = dict(
            chain_nan_max_abs_err=err, chain_nan_rows=rows,
            chain=chain_errs, stream=stream_errs,
            stream_skipped=stream_skips,
            step_grads=cs.check_step_small(np.random.default_rng(SEED),
                                           device),
            train_run=cs.check_train_small(np.random.default_rng(SEED),
                                           device),
            coupling=cs.check_coupling_small(device))
        print(json.dumps({"check": result["check"]}), flush=True)
    probes = [("chain_nan", chain_nan), ("step_host", step_host),
              ("coupling", coupling), ("stream", stream), ("chain", chain),
              ("train", lambda dev: train(dev, clocks=args.variants)),
              ("families", families), ("mixed_grads", mixed_grads),
              ("members", members), ("a6", a6),
              ("example_parts", example_parts), ("ckpt", ckpt)]
    if args.variants:
        probes.append(("train_variants", train_variants))
    if args.variants:
        probes.append(("variants", variants))
    if args.only:
        keep = args.only.split(",")
        probes = [p for p in probes if p[0] in keep]
    for name, fn in probes:
        result[name] = fn(device)
        print(json.dumps({name: result[name]}), flush=True)
    build = os.path.join(TREE, "build")
    result["sass"] = {
        k: sass_mix(os.path.join(build, f"lib{lib}_*.so"), k)
        for lib, k in (("coupling_kernels", "coupling_product_kernel"),
                       ("step_kernels", "step_grads_kernel"),
                       ("stream_kernels", "train_stream_kernel"),
                       ("chain_kernels", "chain_apply_kernel"))}
    print(json.dumps({"sass": result["sass"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-rank"]:
        sys.exit(ckpt_process(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5]))
    sys.exit(main())
