"""gather_dev.train: the share of the port's df.gather spans that pick the
splits' rows (those with the count dev), over train() calls, that picked them
on the device (DataArrays.normalized_splits_on; entry points)."""

from ._stages import count_share

UNIT = "%"


def read(sl):
    return count_share(sl, ("train",), "df.gather", "dev")
