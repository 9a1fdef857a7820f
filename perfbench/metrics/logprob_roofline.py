"""logprob_roofline: the least time of the log_prob calls (operations at 495 TFLOP/s or bytes at 3.35 TB/s) over the device time of all kernels inside them (kernels)."""

from ._common import roofline

UNIT = "%"


def read(sl):
    return roofline(sl, "log_prob")
