"""spline_ms.train: the mean over train() calls of the time of the port's
df.spline spans (each rational-quadratic spline evaluation of a spline
coupling, in the steps and in the per-epoch evaluation), summed over the
call (layers and conditioners, models/layers.py)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", {"df.spline"})
