"""plan_ms.logprob: the mean over log_prob calls of the self time of the port's
df.plan span: the routing checks and the plan cache's lookup, or its rebuild
(routing, fold and kernel wrappers)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "log_prob", ("df.plan",))
