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
- ``coupling``: ``coupling_bwd`` at the opt-in train step's shape (8192 rows,
  K 24, A 16, hidden 256, three dense layers per net): call time, the
  device time of each kernel and of each launch from ``torch.profiler``,
  ``coupling_fwd``'s call and device time, and the time of six
  ``w.t().contiguous()`` copies of the nets' weights.

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
import hashlib
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
    return dict(rows=B, K=K, A=y.shape[1], hidden=s[0][0].shape[1],
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
        clk = torch.zeros(16, device=device)
        kernel(clocks=clk)
        torch.cuda.synchronize()
        c = clk.tolist()
        steps = c[8]
        names = ("denominator", "stage_parameters", "tiles", "sync_tiles",
                 "reduce", "sync_reduce", "update", "sync_update")
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


def use_stream_library(lib):
    """Point the train_stream wrapper at ``lib`` (argtypes as its _library
    sets)."""
    import ctypes

    i, v = ctypes.c_int, ctypes.c_void_p
    lib.df_train_stream.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), i, i, i, v]
    lib.df_train_stream.restype = i
    lib.df_train_stream_max_blocks.argtypes = [i, i, ctypes.POINTER(i)]
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
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from densityflows_tpu_torch import _build

    out_dir = os.path.join(_build.build_dir(), "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = [("step_kernels", tag, flags)
            for tag, flags in STEP_VARIANTS.items()]
    jobs.append(("stream_kernels", "clocks", ["-DDF_STREAM_CLOCKS=1"]))
    jobs.append(("chain_kernels", "clocks", ["-DDF_CHAIN_CLOCKS=1"]))

    def one(job):
        src, tag, flags = job
        so = os.path.join(out_dir, f"lib{src}_{tag}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
               _build.source_path(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} {tag}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        return job[:2], ctypes.CDLL(so)

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(pool.map(one, jobs))


def use_chain_library(lib):
    """Point the chain wrappers at ``lib`` (argtypes as its _library sets)."""
    import ctypes

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.df_chain_apply.argtypes = [p, p, p, p, p, i, p, p, ll, i, i, i, i, p]
    lib.df_chain_apply.restype = i
    lib.df_chain_sample.argtypes = [p, p, p, i, p, i, p, p, ll, i, i, i,
                                    ctypes.c_uint, ctypes.c_uint, i, p]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/probe.json")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="import the package from this checkout instead")
    ap.add_argument("--only", default=None,
                    help="comma-separated probes to run (chain_nan, "
                         "step_host, coupling, stream, chain, variants)")
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

        import contextlib
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
            coupling=cs.check_coupling_small(device))
        print(json.dumps({"check": result["check"]}), flush=True)
    probes = [("chain_nan", chain_nan), ("step_host", step_host),
              ("coupling", coupling), ("stream", stream), ("chain", chain)]
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
    sys.exit(main())
