"""Host ms of a decode step of the traced rollout: the median of the
program's ``tokens.step`` spans."""

from ccvs_bench.spans import host_ms


def read(r):
    return host_ms(r, "tokens.step")
