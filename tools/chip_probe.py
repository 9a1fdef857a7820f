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
- ``coupling``: ``coupling_bwd`` at the opt-in train step's shape (8192 rows,
  K 24, A 16, hidden 256, three dense layers per net): call time, the
  device time of each kernel and of each launch from ``torch.profiler``,
  ``coupling_fwd``'s call and device time, and the time of six
  ``w.t().contiguous()`` copies of the nets' weights.

With ``--variants`` it builds ``csrc/step_kernels.cu`` once per setting of
its tuning switch and its per-phase clock build (``-D`` flags, into
``build/variants/``) and times each build at the shapes above, in two rounds,
each against the plain version; the clock builds give the cycles of every
phase of a tile.

With ``--check`` it first builds the five kernel sources with
``-Xptxas -v`` (registers, shared memory and spills of every kernel, printed)
and runs ``chip_smoke.py``'s checks of the chain kernels' NaN rows, of
``step_grads`` and of the coupling kernels against their plain versions, and
fails on any of them: a short first call on the card for a changed kernel.

Prints one JSON object per probe and writes them all to ``--out``. Exits
non-zero without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import densityflows_tpu_torch as dt  # noqa: E402
from densityflows_tpu_torch.models import fused_chain as fc  # noqa: E402
from densityflows_tpu_torch.models import fused_train as ft  # noqa: E402
from densityflows_tpu_torch.ops import chain_kernels as ck  # noqa: E402
from densityflows_tpu_torch.ops import coupling_kernels as cpk  # noqa: E402

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

    def one(job):
        src, tag, flags = job
        so = os.path.join(out_dir, f"lib{src}_{tag}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so,
               _build.source_path(src)]
        subprocess.run(cmd, check=True, capture_output=True)
        return job[:2], ctypes.CDLL(so)

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return dict(pool.map(one, jobs))


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
    out = {}
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = dict(card=card_line(), torch=torch.__version__,
                  cuda=torch.version.cuda)
    if args.check:
        import chip_smoke as cs
        from densityflows_tpu_torch import _build

        t0 = time.time()
        _build.load_libraries(["chain_kernels", "train_kernels",
                               "step_kernels", "stream_kernels",
                               "coupling_kernels"], verbose=True)
        result["build_seconds"] = time.time() - t0
        err, rows = cs.check_chain_nan(np.random.default_rng(SEED + 23),
                                       device)
        result["check"] = dict(
            chain_nan_max_abs_err=err, chain_nan_rows=rows,
            step_grads=cs.check_step_small(np.random.default_rng(SEED),
                                           device),
            coupling=cs.check_coupling_small(device))
        print(json.dumps({"check": result["check"]}), flush=True)
    probes = [("chain_nan", chain_nan), ("step_host", step_host),
              ("coupling", coupling)]
    if args.variants:
        probes.append(("variants", variants))
    for name, fn in probes:
        result[name] = fn(device)
        print(json.dumps({name: result[name]}), flush=True)
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    result["sass"] = {
        k: sass_mix(os.path.join(build, f"lib{lib}_*.so"), k)
        for lib, k in (("coupling_kernels", "coupling_product_kernel"),
                       ("step_kernels", "step_grads_kernel"))}
    print(json.dumps({"sass": result["sass"]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
