"""Training traffic: back-to-back ``train()`` calls by one caller.

The traffic file gives:

- ``fits``: ``false`` — the calls continue one job (``opt_state`` carried
  over), as a chunked or checkpointed run does, each over all the training
  rows in an order the harness draws from the seed (``shuffle=False``);
  ``true`` — each call is a whole fit from fresh weights drawn from the seed
  (``shuffle=True`` with a seeded generator);
- ``epochs``: epochs per call (``"config"``: the configuration's own);
- ``check``: the calls that set-up drives through the same trainer and the
  same ``train()`` call as the window, and that the reference replays after
  the window: first one step on one batch (``loss_gap``, ``grad_gap``),
  then ``check.epochs`` epochs over ``check.batches`` full batches plus as
  many rows as the window's last, partial batch holds (``"all"``: all the
  training rows, as a window call takes them; ``epoch_loss_gap`` on its
  first epoch's NLLs, whose batches hold that partial one, and ``step_gap``
  on the weights after all its epochs), and with ``check.fit`` one whole
  window call (``fit_loss_gap`` on every epoch's NLLs). Under ``fits`` each call starts from the
  first weights with no state, as every fit does; otherwise each continues
  the one before;
- ``trace_calls``: calls in the traced slice.

The data is the configuration's: its file, or ``train.rows`` rows of its
simulator made from the seed. ``train()`` takes host arrays, so the rows live
in host memory and each call uploads its split.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import work
from ..check import leaf_gap, moved_leaves, scalar_gap
from ..inputs import Problem, draw_weights, sub_seed
from ..reference.train import replay
from ..trace import NullTracer, Tracer
from . import check_keys

__all__ = ["run", "setup_data", "checked_calls", "check_readings",
           "train_gaps", "control_gaps"]

KEYS = ("fits", "epochs", "check", "trace_calls")


def setup_data(cfg, problem):
    """Host copies of the rows and the seeded split: ``(x_dev, th_dev,
    x_np, th_np, train_idx, valid_idx)``."""
    if cfg["data"]["kind"] == "file":
        x, th = problem.file_x, problem.file_theta
    else:
        x, th = problem.rows(int(cfg["train"]["rows"]), "train")
    tr, va = problem.split(x.shape[0])
    return x, th, x.cpu().numpy(), th.cpu().numpy(), tr, va


def _epochs(cfg, value) -> int:
    return int(cfg["train"]["epochs"]) if value == "config" else int(value)


def checked_calls(cfg, traffic, seed: int, tr) -> list[dict]:
    """The calls set-up checks (see the module's docstring), each with
    ``role`` (``step``, ``epochs``, ``fit``), ``idx`` (training rows in
    order), ``epochs``, ``gen_seed`` (None: no shuffle) and ``reset``."""
    check_keys(traffic, KEYS)
    bs = int(cfg["train"]["batchsize"])
    fits = bool(traffic["fits"])
    chk = traffic["check"]
    check_keys(chk, ("batches", "epochs", "fit"))
    order = np.random.default_rng(sub_seed(seed, "check_order")).permutation(tr)
    if chk["batches"] == "all":
        second = tr if fits else order
    else:
        rows = int(chk["batches"]) * bs + len(tr) % bs
        second = order[bs:bs + rows]
    calls = [{"role": "step", "idx": order[:bs], "epochs": 1},
             {"role": "epochs", "idx": second,
              "epochs": _epochs(cfg, chk["epochs"])}]
    if chk.get("fit", False):
        calls.append({"role": "fit", "idx": tr if fits else order,
                      "epochs": _epochs(cfg, traffic["epochs"])})
    for k, c in enumerate(calls):
        c["gen_seed"] = sub_seed(seed, "check_fit", k) if fits else None
        c["reset"] = fits
    return calls


class PortTrainer:
    """The program: a ``Flow`` of the configuration and ``train()``."""

    def __init__(self, cfg, leaves, problem, device, x_np, th_np):
        from .. import system
        import densityflows_tpu_torch as dt

        self.cfg, self.system, self.dt = cfg, system, dt
        self.flow = system.build_flow(cfg, leaves, problem, device)
        if str(device).startswith("cuda"):
            system.load_kernels(cfg, "train")
        self.x_np, self.th_np = x_np, th_np
        self.state = None
        opt = cfg["optimizer"]
        self.optimizer = dt.adam(opt["lr"], opt["b1"], opt["b2"], opt["eps"])

    def reset(self, leaves):
        self.system.load_leaves(self.cfg, self.flow, leaves)
        self.state = None

    def call(self, train_idx, valid_idx, *, epochs, batchsize, gen_seed):
        """One ``train()`` call; ``gen_seed`` None: no shuffle. Returns its
        per-epoch ``(train NLL, valid NLL)``."""
        data = self.system.data_arrays(self.x_np, self.th_np, train_idx,
                                       valid_idx)
        gen = (torch.Generator().manual_seed(gen_seed)
               if gen_seed is not None else None)
        n0 = len(self.flow.train_loss)
        self.state = self.dt.train(
            self.flow, data, self.optimizer, self.state, epochs=epochs,
            batchsize=batchsize, shuffle=gen is not None, verbose=False,
            generator=gen)
        return list(zip(self.flow.train_loss[n0:], self.flow.valid_loss[n0:]))

    def first_moment(self) -> dict:
        names = self.system.leaf_names_in_state_order(self.cfg, self.flow)
        return {k: m.detach().clone() for k, m in zip(names, self.state.mu)}

    def params(self) -> dict:
        return {k: p.detach().clone() for k, p in
                self.system.port_leaves(self.cfg, self.flow).items()}

    def route(self):
        return self.system.route(self.flow)

    def reset_route(self):
        self.system.reset_route()


def check_readings(trainer, calls, leaves0, va, batchsize):
    """Drive ``calls`` and keep what the reference compares: each call's
    per-epoch NLLs and weights after it, and the first moment after the
    first call."""
    losses, params, mu1 = [], [], None
    for k, c in enumerate(calls):
        if c["reset"]:
            trainer.reset(leaves0)
        losses.append(trainer.call(c["idx"], va, epochs=c["epochs"],
                                   batchsize=batchsize,
                                   gen_seed=c["gen_seed"]))
        params.append(trainer.params())
        if k == 0:
            mu1 = trainer.first_moment()
    return {"losses": losses, "mu1": mu1, "params": params}


def _losses_gap(prog, ref, epochs=None) -> float:
    """The widest gap of the NLLs of the first ``epochs`` epochs (None: all);
    infinite where the two sides report a different number of epochs."""
    if len(prog) != len(ref):
        return float("inf")
    gap = 0.0
    for (tl, vl), (rt, rv) in zip(prog[:epochs], ref[:epochs]):
        gap = max(gap, scalar_gap(float(tl), rt), scalar_gap(float(vl), rv))
    return gap


def train_gaps(calls, cfg, readings, ref, params0):
    """The training numbers of ``readings`` (the program's) against ``ref``
    (:func:`replay`'s), from the weights ``params0``."""
    b1 = float(cfg["optimizer"]["b1"])
    out = {}
    for role, key, epochs in (("step", "loss_gap", None),
                              ("epochs", "epoch_loss_gap", 1),
                              ("fit", "fit_loss_gap", None)):
        for k, c in enumerate(calls):
            if c["role"] == role:
                out[key] = _losses_gap(readings["losses"][k],
                                       ref["losses"][k], epochs)
    names = moved_leaves(ref["grad1"])
    out["grad_gap"] = leaf_gap(
        {k: v / (1.0 - b1) for k, v in readings["mu1"].items()},
        ref["grad1"], names)
    k = [c["role"] for c in calls].index("epochs")
    out["step_gap"] = leaf_gap(
        {n: readings["params"][k][n] - params0[n] for n in names},
        {n: ref["params"][k][n] - params0[n] for n in names}, names)
    return out


def _replay(cfg, problem, leaves, x, th, va, calls, **kw):
    return replay(cfg, leaves, problem.norm_x, problem.theta_lo,
                  problem.theta_hi, x, th, calls, va, **kw)


def run(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    problem = Problem(cfg, ctx.seed, ctx.device)
    x, th, x_np, th_np, tr, va = setup_data(cfg, problem)
    _, leaves = draw_weights(cfg, ctx.seed, ctx.device)
    params0 = {k: v.clone() for k, v in leaves.items()}
    calls = checked_calls(cfg, t, ctx.seed, tr)
    ctx.mark("inputs")
    trainer = PortTrainer(cfg, leaves, problem, ctx.device, x_np, th_np)
    ctx.mark("program")
    batchsize = int(cfg["train"]["batchsize"])
    epochs = _epochs(cfg, t["epochs"])
    fits = bool(t["fits"])
    readings = check_readings(trainer, calls, params0, va, batchsize)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    trainer.reset_route()
    ctx.mark("checked_calls")
    setup_s = time.time() - ctx.t_start
    ctx.log_line("setup", ctx.marks)

    n_batches = -(-len(tr) // batchsize)
    ops, nbytes = work.of(cfg).train(epochs * len(tr), epochs * n_batches)
    order_rng = np.random.default_rng(sub_seed(ctx.seed, "order"))
    tracer = Tracer() if ctx.trace else NullTracer()
    limit_calls = int(t["trace_calls"]) if ctx.trace else None
    rows, calls_done, attempted, failed, call_s = 0, 0, 0, 0, []
    with tracer:
        start = time.perf_counter()
        while (time.perf_counter() - start < ctx.seconds
               if limit_calls is None else calls_done < limit_calls):
            if fits:
                _, fresh = draw_weights(cfg, ctx.seed, ctx.device, "fit",
                                        attempted)
                trainer.reset(fresh)
                order = tr
            else:
                order = order_rng.permutation(tr)
            attempted += 1
            t0 = time.perf_counter()
            try:
                with tracer.span("train", rows=epochs * len(tr), ops=ops,
                                 bytes=nbytes):
                    trainer.call(order, va, epochs=epochs,
                                 batchsize=batchsize,
                                 gen_seed=sub_seed(ctx.seed, "fit", attempted)
                                 if fits else None)
                    sync()
            except (RuntimeError, ValueError, TypeError) as e:
                failed += 1
                ctx.log(f"train call {attempted} failed: {e}")
                continue
            call_s.append(time.perf_counter() - t0)
            rows += epochs * len(tr)
            calls_done += 1
        end = time.perf_counter()
    window = end - start
    route = trainer.route()
    ctx.log_line("route", route)
    ctx.log_line("calls", {
        "completed": calls_done, "attempted": attempted, "failed": failed,
        "window_s": window, "rows_per_call": epochs * len(tr),
        "call_s": [min(call_s), float(np.median(call_s)), max(call_s)]
        if call_s else None,
        "last_train_nll": trainer.flow.train_loss[-1]})
    result = {"attempted": attempted, "failed": failed,
              "metrics": {"setup_s": setup_s,
                          "train_rows_per_s": rows / window}}
    if ctx.trace:
        result["slice"] = tracer.reduce()
    result["memory_peak_bytes"] = ctx.memory_peak()
    del trainer
    t_ref = time.time()
    ref = _replay(cfg, problem, params0, x, th, va, calls)
    result["checks"] = train_gaps(calls, cfg, readings, ref, params0)
    ctx.log_line("reference_s", time.time() - t_ref)
    ctx.log_line("checked", {
        "steps": [c["epochs"] * -(-len(c["idx"]) // batchsize)
                  for c in calls],
        "leaves": [len(moved_leaves(ref["grad1"])), len(ref["grad1"])],
        "epoch_gaps": [[max(scalar_gap(float(a), r) for a, r in
                            zip(pe, re)) for pe, re in zip(pc, rc)]
                       for pc, rc in zip(readings["losses"],
                                         ref["losses"])][1:]})
    return result


def control_gaps(ctx, fault: str = "tf32"):
    """The readings of the reference put in the program's place, on the
    calls a run of this seed checks: computed in TF32 (``"tf32"``, the
    control), with half of each batch left out and the mean taken over the
    rest (``"half_batch"``), or returning its state unchanged
    (``"unchanged"``)."""
    if fault not in ("tf32", "half_batch", "unchanged"):
        raise ValueError(f"unknown fault {fault!r}")
    cfg, t = ctx.cfg, ctx.traffic
    problem = Problem(cfg, ctx.seed, ctx.device)
    x, th, _, _, tr, va = setup_data(cfg, problem)
    _, leaves = draw_weights(cfg, ctx.seed, ctx.device)
    calls = checked_calls(cfg, t, ctx.seed, tr)
    ref = _replay(cfg, problem, leaves, x, th, va, calls)
    low = _replay(cfg, problem, leaves, x, th, va, calls,
                  tf32=fault == "tf32",
                  fault=None if fault == "tf32" else fault)
    b1 = float(cfg["optimizer"]["b1"])
    mu1 = {k: (0.0 if fault == "unchanged" else 1.0 - b1) * g
           for k, g in low["grad1"].items()}
    readings = {"losses": low["losses"], "mu1": mu1, "params": low["params"]}
    return train_gaps(calls, cfg, readings, ref, leaves)
