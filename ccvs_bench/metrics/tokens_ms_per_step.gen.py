"""Device ms of the token stage (the span around ``transformer.generate``) a
decode step, median over the window's rollouts."""

from ccvs_bench.readers import span_ms


def read(r):
    return span_ms(r, "tokens")
