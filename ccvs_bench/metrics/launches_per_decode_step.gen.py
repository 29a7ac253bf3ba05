"""Launch calls (kernels, copies, memsets, graphs) a decode step of the
traced rollout: those made inside the program's ``tokens.step`` spans over
their number; nothing unless every K2 launch of the traffic's positions
joins to a call inside them."""

from ccvs_bench.spans import launches_per_step


def read(r):
    return launches_per_step(r, "tokens.step")
