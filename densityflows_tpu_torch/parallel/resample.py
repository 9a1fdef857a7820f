"""Distributed systematic resampling over a particle axis split across the
ranks of a mesh.

PyTorch counterpart of ``densityflows_tpu/parallel/resample.py``. Each rank
holds its contiguous block of the log-weights and particles, and no rank
ever holds the whole (n,) weight vector or the whole (n, d) particle
matrix:

1. the global maximum log-weight (one ``all_reduce(MAX)``) and the ranks'
   weight sums (one (P,) ``all_gather``) give each rank its exclusive prefix
   offset into the global CDF and its local CDF slice (one local cumsum);
2. ancestors are fetched with a ring pass: the particle block, the CDF
   block and its lower bound travel to rank+1 (``batch_isend_irecv``, P−1
   rotations after the own block), and each rank picks up the rows whose
   CDF interval covers its stratified grid points.

Systematic resampling assigns ancestors monotonically, so every rank's
output rows are a contiguous range of the global ancestor sequence and a
visiting block resolves exactly the grid points that fall in its CDF
interval. On a one-rank mesh no point-to-point message is sent, and the
rows equal ``inference.systematic_resample``'s for the same u₀: the two do
the same arithmetic there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..inference import _cumsum, _nan_last

__all__ = ["systematic_resample_sharded"]


def _ring_pass(mesh, tensors):
    """Send each tensor to rank+1 and receive its counterpart from rank−1
    (CUDA tensors of a gloo group travel through host copies)."""
    from .mesh import _carries_cuda

    group = mesh.group
    device = tensors[0].device
    if device.type == "cuda" and not _carries_cuda(group):
        return [r.to(device)
                for r in _ring_pass(mesh, [t.cpu() for t in tensors])]
    nxt = dist.get_global_rank(group, (mesh.rank + 1) % mesh.size)
    prv = dist.get_global_rank(group, (mesh.rank - 1) % mesh.size)
    recvs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


def systematic_resample_sharded(log_weights, particles, generator, mesh, *,
                                axis: str = "data", u0=None):
    """Systematic resampling of this rank's block of ``particles`` (n/P, d)
    by its block of ``log_weights`` (n/P,), the blocks in rank order along
    ``mesh``'s ``data`` axis (every rank holds the same number of rows).
    Returns this rank's block of the resampled particles, uniform weights
    implied.

    ``u0``: the stratified offset in [0, 1); when None, rank 0 draws it from
    ``generator`` and broadcasts it.
    """
    if axis != "data":
        raise ValueError(f"the particle axis is split over the mesh's "
                         f"'data' axis, got {axis!r}")
    p, k = mesh.size, mesh.rank
    device = particles.device
    lw = log_weights.to(torch.float32)
    n_local = particles.shape[0]
    n = n_local * p
    if u0 is None:
        gen_device = generator.device if generator is not None else device
        u0 = torch.rand((), generator=generator, device=gen_device)
    u0 = torch.as_tensor(u0, dtype=torch.float32).to(device).reshape(1)
    m = lw.max().reshape(1)
    mesh.broadcast_data_(u0)
    mesh.all_reduce_(m, op=dist.ReduceOp.MAX)

    # global normalization without an (n,)-sized collective
    c = _cumsum(torch.exp(lw - m))
    sums = mesh.all_gather_rows(c[-1:].contiguous(), p)
    denom = sums.sum()
    offset = sums[:k].sum()
    cdf = _nan_last((offset + c) / denom)
    # the first block also takes the grid points at or below 0, as the
    # clipped search over the whole CDF does
    lo = (offset / denom if k else torch.tensor(float("-inf"),
                                                device=device)).reshape(1)

    # this rank's stratified grid points: global slots [k·n_local,
    # (k+1)·n_local), sorted
    u = (u0 + k * n_local
         + torch.arange(n_local, dtype=torch.float32, device=device)) / n

    out = particles.clone()
    filled = torch.zeros((n_local,), dtype=torch.bool, device=device)
    blk_x, blk_cdf, blk_lo = particles, cdf, lo
    for step in range(p):
        # resolve the grid points covered by the visiting block's interval
        valid = (u > blk_lo) & (u <= blk_cdf[-1]) & ~filled
        sel = torch.searchsorted(blk_cdf, u, side="left").clamp(0, n_local - 1)
        out = torch.where(valid[:, None], blk_x[sel], out)
        filled |= valid
        if step + 1 < p:
            blk_x, blk_cdf, blk_lo = _ring_pass(mesh, [blk_x, blk_cdf, blk_lo])
    # numerical guard: an unfilled slot (u beyond cdf[-1] by rounding) takes
    # the last local particle
    return torch.where(filled[:, None], out, particles[-1])
