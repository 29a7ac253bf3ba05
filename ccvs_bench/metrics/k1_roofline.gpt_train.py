"""K1's share of its roofline in the traced steps, %."""

from ccvs_bench.readers import k1_roofline


def read(r):
    return k1_roofline(r)
