"""host_ms.train: the mean over train() calls of the call's wall time less the device time of what it launched: fold, upload, planning, unfold, host-side evaluation."""

from ._common import host_ms

UNIT = "ms"


def read(sl):
    return host_ms(sl, "train")
