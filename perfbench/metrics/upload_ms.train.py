"""upload_ms.train: the mean over train() calls of the time of the port's
df.upload spans: every host-to-device copy of rows, weights and batch order
(routing, fold and kernel wrappers)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", ("df.upload",))
