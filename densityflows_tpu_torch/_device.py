"""The package's device rule: entry points run on the card unless the caller
asks for the CPU. ``device=None`` means ``"cuda"``; where CUDA is not
available that raises, it does not fall back."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "as_float32"]


def resolve_device(device=None) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "densityflows_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return device


def as_float32(a, device, name="input") -> torch.Tensor:
    """Bring array-like data to a float32 tensor on ``device``. This slice of
    the port is float32 only: an array or tensor of another floating type
    raises (Python scalars and sequences become float32)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        import numpy as np

        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a)
        else:
            t = torch.as_tensor(a, dtype=torch.float32)
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.to(device)
