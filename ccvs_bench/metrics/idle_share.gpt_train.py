"""The device's idle share of the traced steps, %."""

from ccvs_bench.readers import idle_share


def read(r):
    return idle_share(r)
