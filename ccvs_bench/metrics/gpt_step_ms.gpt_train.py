"""Device ms of the GPT's step (forward, backward, AdamW), median over the window's steps."""

from ccvs_bench.readers import span_ms


def read(r):
    return span_ms(r, "step")
