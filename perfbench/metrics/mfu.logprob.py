"""mfu.logprob: the model's operations of every Flow.log_prob row in the traced slice over the calls' summed wall time at 495 TFLOP/s (entry points, models/flow.py)."""

from ._common import mfu

UNIT = "%"


def read(sl):
    return mfu(sl, "log_prob")
