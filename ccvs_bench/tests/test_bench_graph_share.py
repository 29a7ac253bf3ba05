"""``tokens_graph_share.gen`` on synthetic spans: the share of the decode
steps that hold a replay of the decode step's CUDA graph."""

import pytest

from ccvs_bench import harness


def _rollout(replayed):
    """A rollout's spans: one ``tokens.step`` for each entry of
    ``replayed``, holding a ``tokens.sample`` and, where the entry is true,
    a ``tokens.graph``."""
    spans = [("generate", 0, 10_000, None, 0), ("tokens", 1, 9_000, 0, 0)]
    for k, graph in enumerate(replayed):
        t, step = 10 + 100 * k, len(spans)
        spans.append(("tokens.step", t, t + 90, 1, 0))
        spans.append(("tokens.sample", t + 1, t + 20, step, 0))
        if graph:
            spans.append(("tokens.graph", t + 30, t + 40, step, 0))
    return spans


@pytest.mark.parametrize("replayed, share", [([True] * 4, 100.0),
                                             ([True, False, True, False], 50.0),
                                             ([], None), ([False] * 3, None)])
def test_tokens_graph_share(replayed, share):
    """100 % where every step replays, 50 % for half; nothing without
    ``tokens.step`` spans, or from a program that records no graph span."""
    r = {"program_spans": _rollout(replayed)}
    assert harness.read_metric("tokens_graph_share.gen", r) == share


def test_no_tokens_graph_share_without_the_program_s_spans():
    assert harness.read_metric("tokens_graph_share.gen", {"program_spans": None}) is None


@pytest.mark.gpu
def test_every_decode_step_of_a_traced_rollout_replays_the_graph(small_config, cuda):
    """On the card a small traced rollout replays the decode graph in each
    decode step, and the launches and idle share of a step still read (every
    K2 kernel replayed from the graph joins the graph's launch call)."""
    from ccvs_bench import common
    from test_bench_spans import _traced

    _, r = _traced("bairhd.gen_b16", small_config, cuda)
    values = {name: harness.read_metric(name, r) for name in (
        "tokens_graph_share.gen", "launches_per_decode_step.gen", "tokens_idle_share.gen",
        "host_ms_per_decode_step.gen")}
    print(f"graphed rollout: {values}")
    assert values["tokens_graph_share.gen"] == 100.0
    assert all(v is not None for v in values.values()), values
    common.free_cuda()
