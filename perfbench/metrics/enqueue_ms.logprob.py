"""enqueue_ms.logprob: the mean over log_prob calls of the self time of the
port's df.enqueue span: the chain kernel's wrapper, its checks, allocation and
launch (routing, fold and kernel wrappers)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "log_prob", ("df.enqueue",))
