"""The traced steps' model FLOPs over their wall time at the bf16 peak, %."""

from ccvs_bench.readers import mfu


def read(r):
    return mfu(r)
