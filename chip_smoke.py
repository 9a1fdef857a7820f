#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``densityflows_tpu_torch`` from the sources in
this checkout (into ``build/``), holds each kernel against its plain PyTorch
version on the card, then drives the port's serving path at the full width
of the flagship emulator config — d 32, n 8 conditions, 4 coupling blocks
(8 RealNVP couplings) with hidden 256, a trailing normalization layer, 2^18
rows — through the entry points a user calls: ``save_flow`` → ``load_flow``
→ ``log_prob`` / ``sample`` / ``sample_sweep`` / ``forward`` / ``inverse``,
for the split (s-net + t-net) and the joint-conditioner parameterization.
Weights and data are random, from ``numpy.random.default_rng(seed)``.

Every phase fails the run (non-zero exit) on its own failure; there is no
CPU fallback. Without a CUDA device the script exits non-zero and prints no
result. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists, per kernel, its error against the plain version,
its launches on the main path, its time, the plain version's time and the
roofline bound for the same work.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch import _build
from densityflows_tpu_torch.models import fused_chain as fc
from densityflows_tpu_torch.ops import chain_kernels as ck

SEED = 0
D, N_COND, HIDDEN, N_BLOCKS, ROWS = 32, 8, 256, 4, 1 << 18

# Published peaks of one H100 SXM at its full 700 W limit: device memory
# 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s. The kernels do all
# their products as f32 FMA, so that is the rate their bound uses.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version: f32 FMA summed over K in the kernel's own order
# against the library's f32 products (TF32 off), through up to 24 dense
# layers and 8 exp() couplings
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)


def say(**fields):
    print(json.dumps(fields), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require_close(got, want, what, rtol, atol):
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


def check_sample(chain, rows, d, th, what):
    """chain_sample with the base draws written out: the plain fold of the
    draws equals the kernel's samples; the draws are N(0, 1); two seeds
    differ; one seed gives the same draws at both row tiles."""
    plan, params = fc._plan_params(chain, "fwd")
    outs = {}
    for tb in ck.TILE_ROWS:
        outs[tb] = ck.run_chain_sample(plan, params, rows, d, th, seed=1234,
                                       tile_rows=tb, return_noise=True)
        torch.cuda.synchronize()
    (y, r), (y_b, r_b) = (outs[tb] for tb in ck.TILE_ROWS)
    if not torch.equal(r, r_b):
        fail(f"{what}: base draws depend on the row tile")
    require_close(y_b, y, f"{what}: samples at two row tiles", 1e-6, 1e-6)
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


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
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
    b_ms, by = bound_ms(ROWS * flops_per_row,
                        4 * ROWS * (2 * D + N_COND + 1) + pbytes)
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
        "rows_per_s": ROWS / (ms * 1e-3),
    })

    plan_f, params_f = fc._plan_params(chain, "fwd")
    packed_f = ck.pack_plan(plan_f, params_f, D, N_COND)
    ms = time_ms(lambda: ck.run_chain_sample(plan_f, params_f, ROWS, D, th1,
                                             seed=7, packed=packed_f))
    gen = torch.Generator(device=x.device).manual_seed(7)
    plain = time_ms(lambda: ck.chain_sample_plain(plan_f, params_f, ROWS, D,
                                                  th1, generator=gen), runs=5)
    b_ms, by = bound_ms(ROWS * flops_per_row,
                        4 * (ROWS * D + N_COND) + pbytes)
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
        "draws_per_s": ROWS / (ms * 1e-3),
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
    _build.load_library("chain_kernels")
    summary = {"build_seconds": time.time() - t0}
    say(phase="build", seconds=summary["build_seconds"],
        build_dir=_build.build_dir())

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
    say(phase="kernels_small", chain_apply_max_abs_err=err_a,
        chain_sample_max_abs_err=err_s, gradient_max_abs_err=err_g,
        tolerance=KERNEL_TOL)

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

    # phase 4: the main path; launch counts are taken around the driven
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

    # phase 5: times
    for joint in (False, True):
        flow, x, theta, theta_tuple, _ = driven[joint]
        name = "joint" if joint else "split"
        summary[f"times_{name}"] = end_to_end_times(flow, x, theta,
                                                    theta_tuple, name, card)
    flow, x, theta, _, _ = driven[False]
    kernels = kernel_rows(flow, x, theta, errs, launches)

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
