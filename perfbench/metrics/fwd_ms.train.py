"""fwd_ms.train: the mean over train() calls of the self time of the port's
df.forward spans (each plain step's batch loss: the inverse pass, the masked
NLL; its df.spline spans left out), summed over the call (entry points,
train.py). None where the call ran a kernel path."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", {"df.forward"})
