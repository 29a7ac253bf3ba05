"""Host-to-device copies a traced step: those launched inside the
program's ``train.encode`` and ``train.step`` spans, over the steps."""

from ccvs_bench.spans import copies_per_step


def read(r):
    return copies_per_step(r, ("train.encode", "train.step"), "train.step")
