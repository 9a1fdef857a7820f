"""Out-of-core streaming input pipeline and streaming trainer.

PyTorch-port counterpart of ``densityflows_tpu/data_stream.py``. ``train``
uploads the whole data set to the device once — right for data that fits.
This module is the path for data that does not: a host-side loader that
assembles shuffled batches from a (possibly memory-mapped) array with the
native threaded gather (``csrc/loader.cpp``), double-buffers them on a
background thread, and feeds a per-batch train step, so that the host's
assembly of batch k+1 overlaps the device's work on batch k.

Two steps can run a batch:

- the **step kernel**: ``step_grads`` (``ops/step_kernels.py``) on folded
  parameters, then Adam over the flat folded buffer in plain tensor
  operations (``flow.trained_path == "fused-step"``, on a mesh
  ``"fused-step-mesh"``). The model and a caller's Adam state are folded at
  entry and unfolded at exit;
- the **plain step** (``train.make_train_step``): autograd through the
  per-layer path, any optimizer (``"torch"``).

Epoch semantics: a fresh shuffle per epoch, the partial final batch kept
through a mask, per-epoch train (and optional validation) NLL appended to the
flow's histories.

Multi-host: with ``host_id`` / ``num_hosts`` each host streams its own
disjoint row shard of the SAME deterministic global permutation; with a
``mesh`` the ranks' batches form one global batch per step (loss and
gradients summed over the ranks).
"""

from __future__ import annotations

import queue
import threading
import warnings

import numpy as np
import torch

from . import native

__all__ = ["StreamingLoader", "train_streaming"]


class StreamingLoader:
    """Deterministic, double-buffered batch loader over host arrays.

    ``x`` (n, d) and optional ``theta`` (n, k) may be numpy arrays or
    memmaps (``np.load(..., mmap_mode='r')``). Iterating an epoch yields
    ``(x_batch, theta_batch, mask)`` with static shapes; the mask zeroes
    padded rows of the final partial batch.
    """

    def __init__(
        self,
        x,
        theta=None,
        *,
        batchsize: int = 64,
        shuffle: bool = True,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
    ):
        if x.ndim != 2:
            raise ValueError(f"x must be (rows, d), got shape {x.shape}")
        if theta is None:
            theta = np.zeros((x.shape[0], 0), np.float32)
        if theta.shape[0] != x.shape[0]:
            raise ValueError(
                f"x has {x.shape[0]} rows but theta has {theta.shape[0]}")
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.x, self.theta = x, theta
        self.batchsize = int(batchsize)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.host_id, self.num_hosts = int(host_id), int(num_hosts)
        self.prefetch = int(prefetch)
        self._epoch = 0

    @property
    def _rows_per_host_padded(self) -> int:
        # ceil split: every host is sized for the SAME padded row count, so
        # every host runs the SAME number of batches per epoch — unequal
        # step counts would leave a rank waiting in a collective for ever
        # (hosts with fewer real rows emit fully masked padding batches)
        return -(-self.x.shape[0] // self.num_hosts)

    @property
    def rows_per_host(self) -> int:
        """REAL rows this host holds (its contiguous ceil-split chunk of the
        global permutation; late hosts may hold fewer)."""
        n = self.x.shape[0]
        per = self._rows_per_host_padded
        lo = min(self.host_id * per, n)
        return min(lo + per, n) - lo

    @property
    def batches_per_epoch(self) -> int:
        """Identical on every host (the lockstep invariant)."""
        return -(-self._rows_per_host_padded // self.batchsize)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = self.x.shape[0]
        if self.shuffle:
            order = native.shuffle(self.seed * 0x9E3779B9 + epoch + 1, n)
        else:
            order = np.arange(n, dtype=np.int64)
        per = self._rows_per_host_padded
        lo = min(self.host_id * per, n)
        hi = min(lo + per, n)
        return order[lo:hi]

    def _assemble(self, idx: np.ndarray):
        b = self.batchsize
        k = len(idx)
        mask = np.zeros((b,), np.float32)
        mask[:k] = 1.0
        if k < b:
            idx = np.concatenate([idx, np.zeros((b - k,), np.int64)])
        return (
            native.gather_rows(self.x, idx),
            native.gather_rows(self.theta, idx),
            mask,
        )

    def epoch(self, epoch: int | None = None):
        """Iterate one epoch's batches, assembled on a background thread."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = self._epoch_order(epoch)
        # iterate the PADDED range so every host yields the same batch
        # count; starts beyond this host's real rows give all-masked
        # batches (order[s:s+b] is empty → mask all zeros)
        starts = range(0, self._rows_per_host_padded, self.batchsize)
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        sentinel = object()
        failure = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                for s in starts:
                    if stop.is_set():
                        break
                    put(self._assemble(order[s:s + self.batchsize]))
            except Exception as e:    # handed to the consumer below
                failure.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # a consumer that leaves early must not leave the thread waiting
            stop.set()
            t.join()
        if failure:
            raise failure[0]

    def __iter__(self):
        return self.epoch()


class _Stager:
    """A host batch as float32 tensors on the flow's device.

    On a CUDA device the three arrays of a batch go into ONE flat pinned
    buffer and cross in one ``non_blocking`` copy, so the copy of batch k+1
    overlaps the device's work on batch k; a small ring of pinned buffers,
    each with the event of its last copy, keeps a buffer from being refilled
    before that copy has run."""

    _SLOTS = 4

    def __init__(self, device, batchsize: int, d: int, n: int):
        self.device = torch.device(device)
        self.cuts = np.cumsum([batchsize * d, batchsize * n, batchsize])
        self.shapes = ((batchsize, d), (batchsize, n), (batchsize,))
        self.k = 0
        if self.device.type == "cuda":
            total = int(self.cuts[-1])
            self.host = [torch.empty(total, dtype=torch.float32,
                                     pin_memory=True)
                         for _ in range(self._SLOTS)]
            self.events = [None] * self._SLOTS

    def __call__(self, xb, thb, mask):
        arrays = (xb, thb, mask)
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(self.device)
                for a in arrays)
        slot = self.k % self._SLOTS
        self.k += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        host = self.host[slot]
        flat = host.numpy()
        lo = 0
        for a, hi in zip(arrays, self.cuts):
            flat[lo:hi] = np.asarray(a).reshape(-1)
            lo = int(hi)
        dev = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        dev.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.events[slot] = event
        lo, out = 0, []
        for shape, hi in zip(self.shapes, self.cuts):
            out.append(dev[lo:hi].view(shape))
            lo = int(hi)
        return tuple(out)


def train_streaming(
    flow,
    x,
    theta=None,
    optimizer=None,
    opt_state=None,
    *,
    epochs: int = 10,
    batchsize: int = 64,
    shuffle: bool = True,
    seed: int = 0,
    valid_data: tuple | None = None,
    verbose: bool = True,
    host_id: int | None = None,
    num_hosts: int | None = None,
    mesh=None,
    metrics_log: str | None = None,
    fused_kernel: bool | str = "auto",
):
    """Stream-train a flow from host (possibly memory-mapped) arrays, on the
    flow's device.

    θ is normalized per batch through the flow's metadata (the same boundary
    contract as ``train``); the raw arrays stay on the host. ``valid_data =
    (x_valid, theta_valid)`` (raw, un-normalized) adds a per-epoch validation
    NLL. Returns ``opt_state``.

    ``mesh`` (``parallel.mesh.make_mesh()``): each rank of the ``data``
    axis streams ITS OWN loader shard (``host_id`` / ``num_hosts`` default
    to its index and the axis's size), the global batch of a step is the
    ranks' ``batchsize`` rows each, and loss and gradients are summed over
    the axis; the loader's ceil split guarantees every rank the SAME batch
    count per epoch. The ranks of a ``model`` axis stream the same shard and
    each trains its own tensor-parallel shards
    (``parallel.mesh.shard_params_tp``) on the plain step.

    ``fused_kernel``: ``"auto"`` (default) runs the step kernel when the flow
    is on a CUDA device, the optimizer is ``adam(...)`` (or None) and the
    chain is inside the kernel's envelope; a decline is recorded in
    ``flow.fused_decline_reason`` and, for a chain outside the envelope on a
    CUDA flow, raised as a ``RuntimeWarning``. ``True`` forces the step
    kernel (on a CPU flow: its plain version) or raises; ``False`` always
    takes the plain step.
    """
    from .data import normalize_input
    from .models.fused_train import trainable_leaves
    from .parallel.mesh import check_mesh
    from .train import Adam, _eval_nll, make_train_step

    check_mesh(mesh)
    multiproc = mesh is not None and mesh.size > 1
    if host_id is None:
        host_id = mesh.rank if multiproc else 0
    if num_hosts is None:
        num_hosts = mesh.size if multiproc else 1
    if multiproc and num_hosts != mesh.size:
        raise ValueError(
            f"on a multi-process mesh num_hosts ({num_hosts}) must equal "
            f"the mesh's size ({mesh.size})")

    if optimizer is None:
        optimizer = Adam()
    device = flow.device
    fused = _fused_streaming_setup(flow, optimizer, opt_state, mesh,
                                   fused_kernel, batchsize)
    loader = StreamingLoader(
        x, theta, batchsize=batchsize, shuffle=shuffle, seed=seed,
        host_id=host_id, num_hosts=num_hosts)

    model = flow.model
    if fused is not None:
        model, opt_state = fused["enter"]()
        step, eval_nll = fused["step"], fused["eval"]
    else:
        if mesh is not None:
            from .parallel.mesh import put_replicated

            put_replicated(mesh, [p.data for p in trainable_leaves(model)
                                  if p.numel()])
        if opt_state is None:
            opt_state = optimizer.init(trainable_leaves(model))
        step, eval_nll = make_train_step(optimizer, mesh=mesh), _eval_nll
    md = flow.metadata
    theta_min = np.asarray(md.theta_min, np.float32)
    theta_max = np.asarray(md.theta_max, np.float32)

    def norm_theta(th):
        return normalize_input(np.asarray(th, np.float32), theta_min,
                               theta_max)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)

    xv = thv = None
    if valid_data is not None:
        xv = put(valid_data[0])
        thv_raw = valid_data[1]
        if thv_raw is None:
            thv_raw = np.zeros((valid_data[0].shape[0], 0), np.float32)
        thv = put(norm_theta(np.asarray(thv_raw)))

    logger = None
    if metrics_log is not None:
        from .utils.logging import MetricsLogger

        logger = MetricsLogger(metrics_log)

    stage = _Stager(device, batchsize, x.shape[1], loader.theta.shape[1])
    for e in range(epochs):
        losses, weights = [], []
        for xb, thb, mask in loader.epoch(e):
            x_t, th_t, m_t = stage(xb, norm_theta(thb), mask)
            denom = None
            if multiproc:
                # the loss is the GLOBAL masked NLL, so the epoch weighting
                # needs the GLOBAL mask sum; the step takes it as it is
                denom = mesh.all_reduce_(m_t.sum())
                weights.append(denom)
            else:
                weights.append(float(mask.sum()))
            model, opt_state, loss = step(model, opt_state, flow.base, x_t,
                                          th_t, m_t, denom)
            # the losses stay on the device: a float() here would wait for
            # every batch and put the host's assembly behind the device's work
            losses.append(loss)
        losses = torch.stack(losses).double().cpu().numpy()
        if multiproc:
            weights = torch.stack(weights).double().cpu().numpy()
        w = np.asarray(weights, np.float64)
        train_nll = float(np.dot(losses, w) / max(w.sum(), 1.0))
        flow.train_loss.append(train_nll)
        extras = {}
        if xv is not None:
            vl = float(eval_nll(model, flow.base, xv, thv))
            flow.valid_loss.append(vl)
            extras["valid_nll"] = vl
        if logger is not None:
            logger.write(epoch=len(flow.train_loss), train_nll=train_nll,
                         **extras)
        if verbose:
            msg = f"epoch: {len(flow.train_loss)} | train_loss = {train_nll}"
            if xv is not None:
                msg += f", valid_loss = {extras['valid_nll']}"
            print(msg)
    if fused is not None:
        opt_state = fused["exit"](model, opt_state)
        flow.trained_path = ("fused-step-mesh" if mesh is not None
                             else "fused-step")
    else:
        flow.trained_path = "torch"
    return opt_state


def _fused_streaming_setup(flow, optimizer, opt_state, mesh, fused_kernel,
                           batchsize):
    """``None`` (the reason in ``flow.fused_decline_reason``), or the
    enter / step / eval / exit callables that run the streaming loop on
    FOLDED parameters with the grads-only step kernel and Adam over the flat
    folded buffer. On a mesh the step is the data-parallel one (local kernel
    → sum over the ranks → folded Adam, ``train.make_fused_step_fn``)."""
    from .models.fused_train import (
        UnsupportedFusedTrain,
        fold_for_step,
        fold_for_step_mesh,
        load_leaves_,
    )
    from .ops.step_kernels import folded_nll
    from .train import (
        Adam,
        AdamState,
        _adam_hp,
        _fold_adam_state,
        _unfold_adam_state,
        make_fused_step_fn,
    )

    forced = fused_kernel is True
    on_cuda = flow.device.type == "cuda"

    def decline(reason, warn=False):
        if forced:
            raise UnsupportedFusedTrain(reason)
        flow.fused_decline_reason = reason
        if warn:
            warnings.warn(
                f"train_streaming: the step kernel declined this run "
                f"({reason}); the plain step trains it, one launch per "
                "operation. Pass fused_kernel=False to choose that path "
                "without this warning", RuntimeWarning, stacklevel=4)
        return None

    if fused_kernel is False:
        flow.fused_decline_reason = "fused_kernel=False"
        return None
    if not forced and not on_cuda:
        return decline(f"non-CUDA device ({flow.device.type})")
    if type(optimizer) is not Adam:
        return decline("optimizer other than adam(...): the folded update "
                       "is Adam's")
    if opt_state is not None and not isinstance(opt_state, AdamState):
        return decline("opt_state is not an Adam state (need count, mu, nu)")
    try:
        # on a mesh with a 'model' axis: JAX's "non-DP mesh axes"
        folded = (fold_for_step(flow) if mesh is None else
                  fold_for_step_mesh(flow, batchsize * mesh.size, mesh))
    except UnsupportedFusedTrain as e:
        return decline(f"outside the step kernel's envelope: {e}",
                       warn=on_cuda)
    flow.fused_decline_reason = None
    sp = folded.step_plan
    hp = _adam_hp(optimizer.learning_rate, optimizer.b1, optimizer.b2,
                  optimizer.eps)
    kernel_step = make_fused_step_fn(mesh, sp, **hp)

    def enter():
        flat_p = sp.flatten(folded.tparams)
        fstate = _fold_adam_state(folded, opt_state)
        if mesh is not None:
            from .parallel.mesh import put_replicated

            put_replicated(mesh, [flat_p, fstate.mu[0], fstate.nu[0]])
        return flat_p, fstate

    def step(flat_p, fstate, base, xb, thb, mask, denom=None):
        del base    # the kernel's base is the StandardNormal
        return kernel_step(flat_p, fstate, xb, thb, mask, denom)

    def eval_nll(flat_p, base, xv, thv):
        del base
        return folded_nll(sp.views(flat_p), sp.cparams, xv, thv,
                          xv.new_ones(xv.shape[0]), plan=sp.plan)

    def exit_(flat_p, fstate):
        load_leaves_(flow.model, folded.unfold(sp.unflatten(flat_p)))
        return _unfold_adam_state(folded, fstate)

    return {"enter": enter, "step": step, "eval": eval_nll, "exit": exit_}
