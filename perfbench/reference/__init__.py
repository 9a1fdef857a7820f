"""The plain reference that decides ``correct``: float32 PyTorch written from
the published equations, importing nothing of the program under test.

One module per configuration kind, ``reference/<kind>.py``, found by the
configuration's ``kind`` (:func:`module`), gives:

- ``param_layout(cfg)``: every trainable tensor as ``(name, shape, role)``,
  role ``hidden`` / ``final`` (a weight, stored (in, out)) or ``bias``, in
  the order of the flat vector the benchmark draws;
- ``Reference(cfg, params, norm_x, theta_lo, theta_hi)``: the flow with the
  weights ``params`` (name → tensor, updated in place by a replay), the data
  rows ``norm_x`` a normalization layer is built from and the prior box,
  with ``d``, ``log_prob(x, θ)``, ``nll(x, θ)`` (mean negative
  log-likelihood) and ``sample(z, θ)`` (base draw → data), θ raw.

``philox.py`` (the served base draw) and ``train.py`` (the Adam replay) serve
every kind.
"""

from __future__ import annotations

import importlib

import torch

__all__ = ["module", "fp32_exact"]


def module(cfg):
    """The reference module of ``cfg["kind"]``."""
    return importlib.import_module(f"{__name__}.{cfg['kind']}")


class fp32_exact:
    """Context: float32 products without TF32 (``tf32=False``), or with it
    (``tf32=True``: the lower precision the control runs in)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
