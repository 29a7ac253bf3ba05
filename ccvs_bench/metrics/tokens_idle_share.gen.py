"""The device's idle share of the token stage of the traced rollout, %:
from the program's ``tokens`` span's start to the end of the last
operation launched inside it."""

from ccvs_bench.spans import idle_share_in


def read(r):
    return idle_share_in(r, "tokens")
