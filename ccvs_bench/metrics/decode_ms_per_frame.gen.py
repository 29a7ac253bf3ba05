"""Device ms of the decode stage (the span around ``ae.decode_video``) a
generated frame, median over the window's rollouts."""

from ccvs_bench.readers import span_ms


def read(r):
    return span_ms(r, "decode")
