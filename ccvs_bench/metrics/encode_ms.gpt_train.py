"""Device ms of ``encode_batch`` (the frozen encode, K1), median over the window's steps."""

from ccvs_bench.readers import span_ms


def read(r):
    return span_ms(r, "encode")
