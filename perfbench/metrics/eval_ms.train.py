"""eval_ms.train: the mean over train() calls of the time of the port's df.eval
spans (the streaming mode's per-epoch evaluation of the snapshots) less the
time in them in which device work begun before them still runs: the host
enqueues the evaluation behind the training kernel and waits for a place in the
launch queue until that kernel ends. None in the resident mode (routing, fold
and kernel wrappers)."""

from ._stages import own_device_ms

UNIT = "ms"


def read(sl):
    return own_device_ms(sl, "train", "df.eval")
