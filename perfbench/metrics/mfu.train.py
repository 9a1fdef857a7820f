"""mfu.train: three times the forward operations of every training row of the slice's train() calls over their summed wall time at 495 TFLOP/s (entry points, train.py)."""

from ._common import mfu

UNIT = "%"


def read(sl):
    return mfu(sl, "train")
