"""train_roofline: the same share for the kernels inside the train() calls (kernels)."""

from ._common import roofline

UNIT = "%"


def read(sl):
    return roofline(sl, "train")
