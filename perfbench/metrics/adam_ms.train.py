"""adam_ms.train: the mean over train() calls of the time of the port's
df.adam spans (each plain step's optimizer update and its in-place add),
summed over the call (entry points, train.py)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", {"df.adam"})
