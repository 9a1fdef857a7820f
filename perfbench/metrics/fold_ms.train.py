"""fold_ms.train: the mean over train() calls of the self time of the port's
df.fold and df.unfold spans: the chain folded and packed, the moments folded,
the results unfolded (routing, fold and kernel wrappers)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "train", ("df.fold", "df.unfold"))
