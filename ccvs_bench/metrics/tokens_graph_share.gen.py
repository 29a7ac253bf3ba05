"""The share of the traced rollout's decode steps that replay the decode
step's CUDA graph, %: the program's ``tokens.step`` spans that hold a
``tokens.graph`` span, over all of them; nothing for a program that records
no ``tokens.graph`` span (one without the graph)."""

from ccvs_bench.spans import program_spans


def read(r):
    spans = program_spans(r) or ()
    steps = [i for i, s in enumerate(spans) if s[0] == "tokens.step"]
    held = {s[3] for s in spans if s[0] == "tokens.graph"}
    if not steps or not held:
        return None
    return 100.0 * sum(i in held for i in steps) / len(steps)
