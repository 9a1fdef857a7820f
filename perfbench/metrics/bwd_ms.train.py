"""bwd_ms.train: the mean over train() calls of the time of the port's
df.backward spans (each plain step's torch.autograd.grad), summed over the
call (entry points, train.py)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", {"df.backward"})
