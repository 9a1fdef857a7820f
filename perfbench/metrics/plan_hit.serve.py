"""plan_hit.serve: the share of the port's df.plan spans, over log_prob and
sample calls, that reused the folded parameters of the plan cache (count hit;
routing, fold and kernel wrappers)."""

from ._stages import count_share

UNIT = "%"


def read(sl):
    return count_share(sl, ("log_prob", "sample"), "df.plan", "hit")
