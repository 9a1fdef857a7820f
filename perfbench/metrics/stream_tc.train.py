"""stream_tc.train: the share of the port's train_stream launches, over
train() calls, that took the tensor-core design (count tc of the df.enqueue
spans around run_fused_train_stream; kernels (csrc))."""

from ._stages import count_share

UNIT = "%"


def read(sl):
    return count_share(sl, ("train",), "df.enqueue", "tc")
