"""host_ms.logprob: the mean over log_prob calls of the call's wall time less the device time of what it launched (routing, fold and wrappers)."""

from ._common import host_ms

UNIT = "ms"


def read(sl):
    return host_ms(sl, "log_prob")
