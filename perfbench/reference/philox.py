"""The base draw of a served sample, written afresh in plain PyTorch.

The program documents its in-kernel draw as Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011) keyed by a 64-bit
seed, with the counter (global row, column pair, 0, 0) and a Box–Muller
transform (cosine branch) of two 24-bit uniforms per value; the seed is two
``torch.randint(0, 2**32)`` words drawn from the caller's generator, low word
first. This module rebuilds that draw from the generator's seed alone, on any
device, so that the reference can push it through its own forward map.

uint32 arithmetic runs in int64 tensors: a 32 x 32-bit product is split into
16-bit halves so that no intermediate passes 2**63.
"""

from __future__ import annotations

import math

import torch

__all__ = ["seed_from_generator_seed", "philox4x32_10", "normal_draw"]

_M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def seed_from_generator_seed(gen_seed: int) -> int:
    """The 64-bit key that a CPU ``torch.Generator`` seeded with
    ``gen_seed`` hands to the sampler: two 32-bit words, low first."""
    g = torch.Generator().manual_seed(int(gen_seed))
    lo, hi = (int(w) for w in torch.randint(0, 2**32, (2,), generator=g,
                                            dtype=torch.int64).tolist())
    return (hi << 32) | lo


def _mulhilo(m: int, c):
    """``(hi, lo)`` 32-bit words of ``m * c`` for uint32 values in int64."""
    c_lo, c_hi = c & 0xFFFF, c >> 16
    p_lo = m * c_lo                      # < 2**48
    p_hi = m * c_hi                      # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors holding uint32 values."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _M32
        k1 = (k1 + _W1) & _M32
    return c0, c1, c2, c3


def _box_muller(b1, b2):
    scale = 1.0 / 16777216.0
    u1 = (b1 >> 8).to(torch.float32) * scale
    u2 = (b2 >> 8).to(torch.float32) * scale
    return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
        torch.tensor(2.0 * math.pi, dtype=torch.float32) * u2)


def normal_draw(seed: int, rows: int, d: int, device, row_offset: int = 0):
    """``(rows, d)`` float32 standard-normal draw of the global rows
    ``row_offset .. row_offset + rows`` under the 64-bit ``seed``."""
    seed &= (1 << 64) - 1
    pairs = (d + 1) // 2
    g = torch.arange(row_offset, row_offset + rows, dtype=torch.int64,
                     device=device)[:, None].expand(rows, pairs)
    p = torch.arange(pairs, dtype=torch.int64,
                     device=device)[None, :].expand(rows, pairs)
    c0, c1, c2, c3 = philox4x32_10(g & _M32, g >> 32, p, torch.zeros_like(p),
                                   seed & _M32, seed >> 32)
    out = torch.empty(rows, 2 * pairs, dtype=torch.float32, device=device)
    out[:, 0::2] = _box_muller(c0, c1)
    out[:, 1::2] = _box_muller(c2, c3)
    return out[:, :d]
