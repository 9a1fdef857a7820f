"""upload_mb.train: the mean over train() calls of the bytes the port's
df.upload spans copied to the device, in 10^6 B (routing, fold and kernel
wrappers)."""

from ._stages import count_mean

UNIT = "MB"


def _mb(value):
    return None if value is None else value * 1e-6


def read(sl):
    return _mb(count_mean(sl, "train", "df.upload", "bytes"))
