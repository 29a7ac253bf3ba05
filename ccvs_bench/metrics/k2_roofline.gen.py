"""K2's share of its roofline in the traced rollout, %."""

from ccvs_bench.readers import k2_roofline


def read(r):
    return k2_roofline(r)
