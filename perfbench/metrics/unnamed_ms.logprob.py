"""unnamed_ms.logprob: the mean over log_prob calls of the time inside the call
in which the device runs nothing and no stage span of the port is open
(device)."""

from ._stages import unnamed_ms

UNIT = "ms"


def read(sl):
    return unnamed_ms(sl, "log_prob")
