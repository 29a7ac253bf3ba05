"""The traced rollout's model FLOPs over its wall time at the bf16 peak, %."""

from ccvs_bench.readers import mfu


def read(r):
    return mfu(r)
