"""The port's tracer (``utils/profiling.py``) on the CPU: off it records
nothing; spans nest with their parent and root; a root opened under
``torch.profiler`` records, on the profiler's clock, and the spans a
profiler alone keeps are bounded; the spans and counters
of a small BAIR-shaped rollout, of beam search, of the continuous rollout,
of step-by-step generation and of a transformer training step; the
kernels' launch counters on a card (marker ``gpu``); and ``trace()``'s
Chrome trace.

This file imports neither JAX nor ccvs_tpu."""

import dataclasses
import json
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccvs_tpu_torch.config import AutoencoderConfig, Config, TransformerConfig
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import ContinuousTransformer, FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer
from ccvs_tpu_torch.utils import profiling

# BAIR's shape at a test's size: one context frame, 16 tokens a frame, 4 frames
CFG = Config(
    ae=AutoencoderConfig(necf=8, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64, z_shape=(4, 4),
                         max_dim=32, skip_memory=3, skip_context=(1, 2, 3)),
    gpt=TransformerConfig(z_num=64, z_len=64, num_blocks=4, cond_len=16, n_layer=2, n_head=2,
                          n_embd=32, z_shape=(4, 4), z_chunk=16, top_k=8),
    n_iter=10)
B, T, SIZE = 2, 4, 16


@pytest.fixture(autouse=True)
def tracer():
    """A tracer off and empty around each test."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _models(cfg=CFG, device="cpu"):
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device=device).init(seed=0)
    tr = TokenTransformer(cfg.gpt, dtype=torch.float32, device=device).init(seed=1)
    return ae, tr


def _clip(device="cpu"):
    g = torch.Generator().manual_seed(4)
    return (torch.rand(B, T, 32, 32, 3, generator=g) * 2 - 1).to(device)


def _by_name(spans):
    return Counter(s[0] for s in spans)


def _parents(spans):
    """``{name: {parent's name}}`` of the recorded spans."""
    out = {}
    for name, _, _, parent, _ in spans:
        out.setdefault(name, set()).add(None if parent is None else spans[parent][0])
    return out


def test_off_records_nothing_and_span_is_one_shared_object():
    assert profiling.span("a") is profiling.span("b") is profiling.root("c")
    with profiling.root("generate"):
        with profiling.span("tokens"):
            profiling.count("k2.launches", 3)
    assert profiling.spans() == []
    # counters count whether or not spans record
    assert profiling.counters() == {"k2.launches": 3}


def test_spans_nest_with_their_parent_and_root():
    profiling.enable()
    with profiling.root("generate"):
        with profiling.span("tokens"):
            with profiling.span("tokens.step"):
                pass
            with profiling.span("tokens.step"):
                with profiling.span("tokens.sample"):
                    pass
        with profiling.span("decode"):
            pass
    with profiling.root("train.step"):
        pass
    got = profiling.spans()
    assert [(n, p, r) for n, _, _, p, r in got] == [
        ("generate", None, 0), ("tokens", 0, 0), ("tokens.step", 1, 0), ("tokens.step", 1, 0),
        ("tokens.sample", 3, 0), ("decode", 0, 0), ("train.step", None, 6)]
    for name, start, end, parent, _ in got:
        assert start <= end, name
        if parent is not None:
            assert got[parent][1] <= start and end <= got[parent][2], name
    profiling.disable()
    with profiling.root("generate"):
        pass
    assert len(profiling.spans()) == 7
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_root_opened_under_a_profiler_records_on_its_clock():
    """Without ``enable()``: a root opened while ``torch.profiler`` records
    turns the tracer on until it closes, and the profiler's host record of
    an operator run inside a span lies within the span's interval (both on
    ``time.time_ns()``); once the profiler has stopped a root records
    nothing."""
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.root("generate"):
            with profiling.span("tokens"):
                torch.mm(a, a)
            time.sleep(0.002)
            with profiling.span("decode"):
                torch.add(a, a)
    with profiling.root("generate"):
        with profiling.span("tokens"):
            torch.mm(a, a)
    spans = profiling.spans()
    assert [s[0] for s in spans] == ["generate", "tokens", "decode"]
    assert profiling.span("x") is profiling.span("y")  # off again once the root closed
    ops = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()}
    tokens, decode = spans[1], spans[2]
    mm, add = ops["aten::mm"], ops["aten::add"]
    assert tokens[1] <= mm[0] <= mm[1] <= tokens[2]
    assert decode[1] <= add[0] <= add[1] <= decode[2]
    assert mm[1] < decode[1] and add[0] > tokens[2]


def test_spans_under_a_profiler_alone_are_bounded(monkeypatch):
    """A root opened under a profiler that finds ``MAX_SPANS`` recorded
    starts the list anew; ``enable()`` keeps every span until ``reset()``."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.root("train.step"):
                with profiling.span("train.optimizer"):
                    pass
    assert [s[0] for s in profiling.spans()] == ["train.step", "train.optimizer"]
    assert [s[4] for s in profiling.spans()] == [0, 0]
    profiling.enable()
    for _ in range(3):
        with profiling.root("train.step"):
            pass
    assert len(profiling.spans()) == 5


def test_a_root_reads_the_profiler_s_flag_only_where_torch_has_it(monkeypatch):
    """Without ``torch.autograd.profiler._is_profiler_enabled`` (a private
    name of torch's) a root records nothing and raises nothing."""
    monkeypatch.delattr(profiling._autograd_profiler, "_is_profiler_enabled")
    with profiling.root("generate"):
        with profiling.span("tokens"):
            pass
    assert profiling.spans() == []
    profiling.enable()
    with profiling.root("generate"):
        pass
    assert len(profiling.spans()) == 1


def test_a_bair_shaped_rollout_s_spans_and_counters():
    """``VideoGenerator.generate`` at BAIR's shape: a decode step for each
    generated position, a sampled token at each, one decode stage, every
    span under the one ``generate`` root, and no kernel launched on the
    CPU."""
    ae, tr = _models()
    profiling.enable()
    out = VideoGenerator(CFG, ae, tr).generate(_clip(), torch.Generator().manual_seed(0),
                                               rec=False, n_ctx_frames=1)
    assert out["fake"].shape == (B, T, 32, 32, 3)
    spans, counts = profiling.spans(), profiling.counters()
    positions = (T - 1) * SIZE
    assert counts == {}
    assert _by_name(spans) == {"generate": 1, "tokens": 1, "tokens.step": positions,
                               "tokens.sample": positions, "decode": 1}
    assert _parents(spans) == {"generate": {None}, "tokens": {"generate"},
                               "tokens.step": {"tokens"}, "tokens.sample": {"tokens.step"},
                               "decode": {"generate"}}
    assert {s[4] for s in spans} == {0}
    assert all(s[2] is not None for s in spans)


@pytest.mark.parametrize("mode", ["beam", "beam_sample", "continuous", "step_by_step"])
def test_every_decode_loop_counts_its_steps(mode):
    """Beam search (pruned and sampled), the continuous GPT's greedy loop and
    step-by-step generation record a ``tokens.step`` span for each pass of
    their loops; beam search samples at each generated position;
    step-by-step decodes each generated frame in a ``decode`` span."""
    profiling.enable()
    if mode.startswith("beam"):
        gcfg = dataclasses.replace(CFG.gpt, beam_size=2, sample=mode == "beam_sample")
        tr = TokenTransformer(gcfg, dtype=torch.float32, device="cpu").init(seed=1)
        code = torch.randint(0, 64, (B, SIZE), generator=torch.Generator().manual_seed(2))
        tr.generate(code, torch.Generator().manual_seed(0), total_len=3 * SIZE)
        steps = samples = 2 * SIZE
    elif mode == "continuous":
        gcfg = TransformerConfig(z_len=32, n_layer=2, n_head=2, n_embd=32, n_in=8)
        ct = ContinuousTransformer(gcfg, dtype=torch.float32, device="cpu").init(seed=3)
        ct.generate(torch.randn(B, 5, 8, generator=torch.Generator().manual_seed(5)), 20)
        steps, samples = 20 - 5 - 1, 0
    else:
        ae, tr = _models()
        out = VideoGenerator(CFG, ae, tr).generate_step_by_step(
            _clip(), torch.Generator().manual_seed(0), n_ctx_frames=1)
        assert out["fake"].shape == (B, T, 32, 32, 3)
        steps = samples = (T - 1) * SIZE
        assert _by_name(profiling.spans())["decode"] == T - 1
    names = _by_name(profiling.spans())
    assert names["tokens.step"] == steps
    assert names["tokens.sample"] == samples
    assert _parents(profiling.spans())["tokens.step"] == {"tokens"}


def test_a_training_step_s_spans():
    """``encode_batch`` then ``step`` of ``TransformerTrainer``: two roots,
    the step's AdamW update once under it, after the loss and its
    gradients."""
    ae = FrameAutoencoder(CFG.ae, dtype=torch.float32, device="cpu").init(seed=0)
    trainer = TransformerTrainer(CFG, ae, dtype=torch.float32, device="cpu")
    state = trainer.init_state()
    profiling.enable()
    tokens = trainer.encode_batch({"vid": _clip()})
    state, metrics = trainer.step(state, tokens)
    assert bool(torch.isfinite(metrics["nll"]))
    spans = profiling.spans()
    assert _by_name(spans) == {"train.encode": 1, "train.step": 1, "train.optimizer": 1}
    assert _parents(spans) == {"train.encode": {None}, "train.step": {None},
                               "train.optimizer": {"train.step"}}
    assert profiling.counters() == {}
    encode, step, optimizer = spans
    assert encode[2] <= step[1] < optimizer[1] <= optimizer[2] <= step[2]


@pytest.mark.gpu
def test_kernel_launch_counters_on_card():
    """On a card the rollout counts K2 once a layer in each decode step and
    K1 twice (the clip's encode and the context frame's re-encode in the
    decode), and no K3 without ``serve_int8``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(CFG, gpt=dataclasses.replace(CFG.gpt, n_embd=128))  # K2's hd 64
    ae, tr = _models(cfg, device="cuda")
    profiling.enable()
    VideoGenerator(cfg, ae, tr).generate(_clip("cuda"), torch.Generator("cuda").manual_seed(0),
                                         rec=False, n_ctx_frames=1)
    counts = profiling.counters()
    assert counts["k2.launches"] == cfg.gpt.n_layer * _by_name(profiling.spans())["tokens.step"]
    assert counts["k1.launches"] == 2 and "k3.launches" not in counts


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), "steps") as prof:
        torch.ones(8).sum()
    assert "aten::sum" in {e.key for e in prof.key_averages()}
    events = json.load(open(tmp_path / "steps.json"))["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    with profiling.trace(None) as none:
        assert none is None
    profiling.device_sync(torch.nn.Linear(2, 2))
    profiling.device_sync({"loss": torch.ones(())})
    profiling.device_sync()
