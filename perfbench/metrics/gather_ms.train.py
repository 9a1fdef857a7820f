"""gather_ms.train: the mean over train() calls of the self time of the port's
df.gather spans: the splits' rows, the weights and the batch order made on the
host (entry points)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", ("df.gather",))
