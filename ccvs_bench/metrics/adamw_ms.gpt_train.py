"""Device ms of AdamW's update: the union of the intervals of the device
operations launched inside the program's ``train.optimizer`` span, median
over the traced steps."""

from ccvs_bench.spans import device_ms_in


def read(r):
    return device_ms_in(r, "train.optimizer")
