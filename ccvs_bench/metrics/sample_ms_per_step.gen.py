"""Host ms of the sampler in a decode step of the traced rollout: the
median of the program's ``tokens.sample`` spans."""

from ccvs_bench.spans import host_ms


def read(r):
    return host_ms(r, "tokens.sample")
