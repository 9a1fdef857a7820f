"""Serving traffic: one caller in a closed loop of ``Flow.log_prob`` and
``Flow.sample_sweep`` requests.

The traffic file gives the mix and sizes:

- ``mix``: ``{"log_prob": weight, "sample": weight}`` — requests per block
  of ``block`` requests, in that ratio;
- ``rows_log2``: ``[lo, hi]`` — row counts are log-uniform over
  ``2**lo .. 2**hi``, taken as the ``block`` quantiles of that law per
  operation, so every seed serves the same sizes in another order;
- ``grid``: θ points of a sampling sweep (its rows are a multiple of it);
- ``pool_rows``: rows of (x, θ) made in set-up that ``log_prob`` requests
  are cut from (``"near_data"`` rows of the configuration's data);
- ``check_every``: about one request in this many (drawn from the seed),
  and the first request and the first of the largest size of each
  operation, is compared with the reference after the window;
- ``trace_seconds``: the length of the traced slice.

A request's latency runs from its sending until its output is ready on the
device; its inputs were made in set-up. The loop sends the next request as
soon as one completes, until ``--seconds`` have passed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, work
from ..check import row_gap
from ..inputs import Problem, draw_weights, sub_seed
from ..reference import fp32_exact
from ..reference.philox import normal_draw, seed_from_generator_seed
from ..trace import NullTracer, Tracer
from . import check_keys

__all__ = ["Requests", "PortServer", "run", "reference_gaps", "control_gaps"]

OPS = ("log_prob", "sample")
KEYS = ("mix", "block", "rows_log2", "grid", "pool_rows", "grid_pool_rows",
        "check_every", "trace_seconds")


class Requests:
    """The seeded, endless request stream of a serving traffic file."""

    def __init__(self, traffic, seed: int, pool_rows: int, grid_rows: int):
        check_keys(traffic, KEYS)
        self.t = traffic
        self.rng = np.random.default_rng(sub_seed(seed, "requests"))
        self.pool_rows, self.grid_rows = pool_rows, grid_rows
        self.block = int(traffic["block"])
        lo, hi = traffic["rows_log2"]
        self.counts = {}
        weights = {op: float(traffic["mix"].get(op, 0)) for op in OPS}
        total = sum(weights.values())
        for op in OPS:
            self.counts[op] = int(round(self.block * weights[op] / total))
        self.sizes = {op: self._quantiles(lo, hi, self.counts[op], op)
                      for op in OPS if self.counts[op]}
        self.max_rows = {op: int(s.max()) for op, s in self.sizes.items()}
        self._queue = []
        self._seen, self._seen_max = set(), set()

    def _quantiles(self, lo, hi, k, op):
        q = lo + (hi - lo) * (np.arange(k) + 0.5) / k
        rows = np.maximum(1, np.round(2.0 ** q)).astype(np.int64)
        if op == "sample":
            g = int(self.t["grid"])
            rows = np.maximum(1, np.round(rows / g)).astype(np.int64) * g
        return rows

    def _refill(self):
        ops = np.concatenate([np.full(self.counts[op], i)
                              for i, op in enumerate(OPS) if self.counts[op]])
        self.rng.shuffle(ops)
        sizes = {op: self.rng.permutation(s) for op, s in self.sizes.items()}
        used = {op: 0 for op in OPS}
        check_every = int(self.t["check_every"])
        for i in ops:
            op = OPS[i]
            rows = int(sizes[op][used[op]])
            used[op] += 1
            req = {"op": op, "rows": rows,
                   "check": bool(self.rng.integers(check_every) == 0)}
            if op == "log_prob":
                req["offset"] = int(self.rng.integers(
                    0, self.pool_rows - rows + 1))
            else:
                req["grid_offset"] = int(self.rng.integers(
                    0, self.grid_rows - int(self.t["grid"]) + 1))
                req["gen_seed"] = int(self.rng.integers(0, 2**62))
            if op not in self._seen:
                self._seen.add(op)
                req["check"] = True
            if rows == self.max_rows[op] and op not in self._seen_max:
                self._seen_max.add(op)
                req["check"] = True
            self._queue.append(req)

    def __next__(self):
        if not self._queue:
            self._refill()
        return self._queue.pop(0)

    def __iter__(self):
        return self


class PortServer:
    """The program: a ``Flow`` of the configuration with the run's
    weights."""

    def __init__(self, cfg, leaves, problem, device):
        from .. import system

        self.system = system
        self.flow = system.build_flow(cfg, leaves, problem, device)
        if str(device).startswith("cuda"):
            system.load_kernels(cfg, "serve")

    def log_prob(self, x, theta):
        return self.flow.log_prob(x, theta)

    def sample(self, grid, n_per, gen_seed):
        return self.flow.sample_sweep(
            grid, n_per, generator=torch.Generator().manual_seed(gen_seed))

    def route(self):
        return self.system.route(self.flow)

    def reset_route(self):
        self.system.reset_route()


def _setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    problem = Problem(cfg, ctx.seed, ctx.device)
    _, leaves = draw_weights(cfg, ctx.seed, ctx.device)
    pool_x, pool_th = problem.near_rows(int(t["pool_rows"]), "pool")
    grid_rows = int(t.get("grid_pool_rows", 4096))
    grid_pool = problem.uniform_theta(grid_rows, "grid")
    ctx.mark("inputs")
    server = PortServer(cfg, leaves, problem, ctx.device)
    ctx.mark("program")
    reqs = Requests(t, ctx.seed, pool_x.shape[0], grid_rows)
    return problem, leaves, pool_x, pool_th, grid_pool, server, reqs


def _send(server, req, pool_x, pool_th, grid_pool, grid):
    if req["op"] == "log_prob":
        sl = slice(req["offset"], req["offset"] + req["rows"])
        return server.log_prob(pool_x[sl], pool_th[sl])
    o = req["grid_offset"]
    return server.sample(grid_pool[o:o + grid], req["rows"] // grid,
                         req["gen_seed"])


def _work(counts, req, grid):
    if req["op"] == "log_prob":
        return counts.logprob(req["rows"])
    return counts.sample(req["rows"], grid)


def _warm_up(server, reqs, pool_x, pool_th, grid_pool, grid):
    """Every operation of the mix at its largest, then its smallest size, so
    that the window allocates and builds nothing new."""
    for op, sizes in reqs.sizes.items():
        for rows in (int(sizes.max()), int(sizes.min())):
            req = {"op": op, "rows": rows, "offset": 0, "grid_offset": 0,
                   "gen_seed": 1}
            with torch.no_grad():
                _send(server, req, pool_x, pool_th, grid_pool, grid)
    if pool_x.is_cuda:
        torch.cuda.synchronize()


def run(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    grid = int(t.get("grid", 1))
    counts = work.of(cfg)
    problem, leaves, pool_x, pool_th, grid_pool, server, reqs = _setup(ctx)
    _warm_up(server, reqs, pool_x, pool_th, grid_pool, grid)
    server.reset_route()
    sync = torch.cuda.synchronize if pool_x.is_cuda else (lambda: None)
    ctx.mark("warm_up")
    setup_s = time.time() - ctx.t_start
    ctx.log_line("setup", ctx.marks)

    seconds = float(t["trace_seconds"]) if ctx.trace else float(ctx.seconds)
    tracer = Tracer() if ctx.trace else NullTracer()
    lat, done_rows = [], {op: 0 for op in OPS}
    kept, attempted, failed = [], 0, 0
    with tracer:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            req = next(reqs)
            attempted += 1
            ops, nbytes = _work(counts, req, grid)
            t0 = time.perf_counter()
            try:
                with tracer.span(req["op"], rows=req["rows"], ops=ops,
                                 bytes=nbytes), torch.no_grad():
                    out = _send(server, req, pool_x, pool_th, grid_pool,
                                 grid)
                    sync()
            except (RuntimeError, ValueError, TypeError) as e:
                failed += 1
                ctx.log(f"request {attempted} ({req['op']}, {req['rows']} "
                        f"rows) failed: {e}")
                continue
            lat.append(time.perf_counter() - t0)
            done_rows[req["op"]] += req["rows"]
            if req["check"]:
                kept.append((req, out))
        end = time.perf_counter()
    window = end - start
    route = server.route()
    ctx.log_line("route", route)
    lat_ms = np.asarray(lat) * 1e3
    ctx.log_line("requests", {
        "completed": len(lat), "attempted": attempted, "failed": failed,
        "window_s": window, "median_ms": float(np.median(lat_ms)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "rows": done_rows, "checked": len(kept)})
    result = {"attempted": attempted, "failed": failed}
    if ctx.trace:
        result["slice"] = tracer.reduce()
    metrics = {"setup_s": setup_s,
               "request_p95_ms": float(np.percentile(lat_ms, 95))}
    if "log_prob" in reqs.sizes:
        metrics["logprob_rows_per_s"] = done_rows["log_prob"] / window
    if "sample" in reqs.sizes:
        metrics["sample_draws_per_s"] = done_rows["sample"] / window
    result["metrics"] = metrics
    result["memory_peak_bytes"] = ctx.memory_peak()
    del server
    t_ref = time.time()
    result["checks"] = reference_gaps(cfg, leaves, problem, kept, pool_x,
                                      pool_th, grid_pool, grid)
    ctx.log_line("reference_s", time.time() - t_ref)
    return result


def _ref_sample(ref, req, grid_pool, grid, device, tf32=False):
    o = req["grid_offset"]
    n_per = req["rows"] // grid
    th = grid_pool[o:o + grid].repeat_interleave(n_per, dim=0)
    noise = normal_draw(seed_from_generator_seed(req["gen_seed"]),
                        req["rows"], ref.d, device)
    with torch.no_grad(), fp32_exact(tf32):
        return ref.sample(noise, th).reshape(grid, n_per, ref.d)


def reference_gaps(cfg, leaves, problem, kept, pool_x, pool_th, grid_pool,
                   grid, *, tf32_program=False, block=65536):
    """The gap numbers of the kept requests against the float32 reference.
    With ``tf32_program`` the kept outputs are ignored and the reference in
    TF32 stands in for the program (the control)."""
    device = pool_x.device
    ref = reference.module(cfg).Reference(cfg, leaves, problem.norm_x,
                                          problem.theta_lo, problem.theta_hi)
    gaps = {}
    lp_req = [(r, o) for r, o in kept if r["op"] == "log_prob"]
    if lp_req:
        worst = 0.0
        for r, out in lp_req:
            sl = slice(r["offset"], r["offset"] + r["rows"])
            x, th = pool_x[sl], pool_th[sl]
            for b0 in range(0, r["rows"], block):
                with torch.no_grad(), fp32_exact():
                    want = ref.log_prob(x[b0:b0 + block], th[b0:b0 + block])
                if tf32_program:
                    with torch.no_grad(), fp32_exact(True):
                        got = ref.log_prob(x[b0:b0 + block],
                                           th[b0:b0 + block])
                else:
                    got = out[b0:b0 + block]
                worst = max(worst, row_gap(got, want))
        gaps["logprob_gap"] = worst
    s_req = [(r, o) for r, o in kept if r["op"] == "sample"]
    if s_req:
        worst = 0.0
        for r, out in s_req:
            want = _ref_sample(ref, r, grid_pool, grid, device)
            got = (_ref_sample(ref, r, grid_pool, grid, device, tf32=True)
                   if tf32_program else out)
            worst = max(worst, row_gap(got, want))
        gaps["sample_gap"] = worst
    return gaps


def checked_requests(traffic, seed, pool_rows, grid_rows, count):
    """The first ``count`` requests of a seed's stream that a run checks
    (for the control, which needs no window)."""
    reqs = Requests(traffic, seed, pool_rows, grid_rows)
    out = []
    while len(out) < count:
        r = next(reqs)
        if r["check"]:
            out.append(r)
    return out


def control_gaps(ctx, fault: str = "tf32", count: int = 48):
    """The control's readings: the reference in TF32 in the program's place,
    on the first ``count`` requests a run of this seed checks."""
    if fault != "tf32":
        raise ValueError("a serving cell's control is the TF32 one")
    t = ctx.traffic
    grid = int(t.get("grid", 1))
    problem = Problem(ctx.cfg, ctx.seed, ctx.device)
    _, leaves = draw_weights(ctx.cfg, ctx.seed, ctx.device)
    pool_x, pool_th = problem.near_rows(int(t["pool_rows"]), "pool")
    grid_rows = int(t.get("grid_pool_rows", 4096))
    grid_pool = problem.uniform_theta(grid_rows, "grid")
    kept = [(r, None) for r in checked_requests(t, ctx.seed, pool_x.shape[0],
                                                grid_rows, count)]
    return reference_gaps(ctx.cfg, leaves, problem, kept, pool_x, pool_th,
                          grid_pool, grid, tf32_program=True)

