"""idle.serve: the share of the traced slice of a serving cell in which no device operation runs (device)."""

from ._common import idle

UNIT = "%"


def read(sl):
    return idle(sl, ("log_prob", "sample"))
