"""sample_roofline: the same share for the kernels inside the sample_sweep calls (kernels)."""

from ._common import roofline

UNIT = "%"


def read(sl):
    return roofline(sl, "sample")
