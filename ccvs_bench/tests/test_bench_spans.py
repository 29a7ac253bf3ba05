"""The arithmetic of ``spans.py`` on synthetic spans and trace records (the
join of each device operation to its launch call and of that call to a
span, the idle share inside a stage, the device time of a span's
operations, the copies a step, and nothing where the join misses a K2
launch or the program records no spans), then on the card (marker
``gpu``): the traced rollout and training steps of both entries at a small
size, every K2 kernel joined to a launch call inside a ``tokens.step`` span,
and every new metric read."""


import pytest

from ccvs_bench import common, harness, spans
from ccvs_bench.entries import generate, gpt_train

NEW_GEN = ("host_ms_per_decode_step.gen", "sample_ms_per_step.gen",
           "launches_per_decode_step.gen", "tokens_idle_share.gen", "decode_idle_share.gen")
NEW_TRAIN = ("adamw_ms.gpt_train", "h2d_copies_per_step.gpt_train")

# a rollout: two decode steps, then the decode stage (ns on one clock)
ROLLOUT_SPANS = [("generate", 0, 1000, None, 0), ("tokens", 10, 600, 0, 0),
                 ("tokens.step", 10, 300, 1, 0), ("tokens.sample", 20, 50, 2, 0),
                 ("tokens.step", 300, 600, 1, 0), ("tokens.sample", 305, 308, 4, 0),
                 ("decode", 600, 1000, 0, 0)]
ROLLOUT_RECORDS = [
    ("cudaLaunchKernel", False, 30, 40, 1), ("flash_decode_kernel<bf16>", True, 100, 150, 1),
    ("cuLaunchKernelEx", False, 310, 320, 2), ("flash_decode_kernel<bf16>", True, 330, 400, 2),
    ("cudaMemcpyAsync", False, 500, 510, 3), ("Memcpy HtoD (Pageable -> Device)", True, 520,
                                               700, 3),
    ("cudaLaunchKernel", False, 650, 660, 4), ("conv", True, 700, 900, 4),
    ("unlinked", True, 950, 960, 99)]


def readings(span_list, records, **kw):
    r = {"program_spans": span_list, "program_joined": spans.Joined(span_list, records)}
    r.update(kw)
    return r


def test_launch_records_are_the_calls_that_put_work_on_the_device():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch"):
        assert spans.is_launch(name), name
    for name in ("cudaStreamIsCapturing", "cudaStreamSynchronize", "aten::copy_",
                 "Activity Buffer Request", "cudaFuncGetAttributes"):
        assert not spans.is_launch(name), name


def test_the_join_places_each_operation_by_its_launch_call():
    j = spans.Joined(ROLLOUT_SPANS, ROLLOUT_RECORDS)
    steps = j.launched_in("tokens.step")
    assert [[op for _, _, op in ops] for ops in steps] == [
        ["flash_decode_kernel<bf16>"], ["flash_decode_kernel<bf16>",
                                        "Memcpy HtoD (Pageable -> Device)"]]
    assert [[op for _, _, op in ops] for ops in j.launched_in("decode")] == [["conv"]]
    assert j.launch_calls_in("tokens.step") == 3 and j.launch_calls_in("tokens.sample") == 1


def test_the_rollout_metrics_on_a_synthetic_trace():
    r = readings(ROLLOUT_SPANS, ROLLOUT_RECORDS, k2_launches=2)
    assert spans.host_ms(r, "tokens.step") == pytest.approx(295 / 1e6)  # 290 and 300
    assert spans.host_ms(r, "tokens.sample") == pytest.approx(16.5 / 1e6)
    assert spans.launches_per_step(r) == 1.5
    # tokens: [10, 700], busy 50 + 70 + 180; decode: [600, 900], the copy's
    # last 100 and the convolution's 200
    assert spans.idle_share_in(r, "tokens") == pytest.approx(100 * (1 - 300 / 690))
    assert spans.idle_share_in(r, "decode") == pytest.approx(0.0)
    assert spans.idle_share_in(r, "train.step") is None


def test_no_reading_where_the_join_misses_a_k2_launch():
    assert spans.launches_per_step(readings(ROLLOUT_SPANS, ROLLOUT_RECORDS,
                                            k2_launches=3)) is None
    # a K2 kernel whose launch call the trace lost
    records = [rec for rec in ROLLOUT_RECORDS if rec[4] != 2]
    records.append(("flash_decode_kernel<bf16>", True, 330, 400, 2))
    assert spans.launches_per_step(readings(ROLLOUT_SPANS, records, k2_launches=2)) is None


def test_the_training_metrics_on_a_synthetic_trace():
    span_list = [("train.encode", 0, 100, None, 0), ("train.step", 100, 400, None, 1),
                 ("train.optimizer", 300, 400, 1, 1), ("train.encode", 500, 600, None, 3),
                 ("train.step", 600, 900, None, 4), ("train.optimizer", 800, 900, 4, 4)]
    records = [("cudaMemcpyAsync", False, 10, 20, 1), ("Memcpy HtoD (Pinned -> Device)", True,
                                                        30, 40, 1),
               ("cudaMemcpyAsync", False, 150, 160, 2), ("Memcpy HtoD (Pageable -> Device)",
                                                         True, 170, 180, 2),
               ("cudaMemcpyAsync", False, 170, 175, 5), ("Memcpy DtoD (Device -> Device)",
                                                         True, 180, 185, 5),
               # AdamW's kernels: two that overlap, then one alone
               ("cudaLaunchKernel", False, 310, 311, 3), ("adam_a", True, 320, 360, 3),
               ("cudaLaunchKernel", False, 312, 313, 4), ("adam_b", True, 340, 380, 4),
               ("cudaLaunchKernel", False, 810, 811, 6), ("adam_a", True, 820, 870, 6)]
    r = readings(span_list, records)
    assert spans.device_ms_in(r, "train.optimizer") == pytest.approx(55 / 1e6)
    assert spans.copies_per_step(r) == 1.0
    assert spans.union_ns([(0, 10), (5, 20), (30, 40), (32, 35)]) == 30


def test_nothing_to_read_without_the_program_s_spans():
    r = {"program_spans": None, "trace": None, "k2_launches": 2}
    for read in (lambda: spans.host_ms(r, "tokens.step"), lambda: spans.launches_per_step(r),
                 lambda: spans.idle_share_in(r, "tokens"),
                 lambda: spans.device_ms_in(r, "train.optimizer"),
                 lambda: spans.copies_per_step(r)):
        assert read() is None
    for name in NEW_GEN + NEW_TRAIN:
        assert harness.read_metric(name, dict(r)) is None, name


def _traced(cell_name, small_config, device):
    cell = harness.find_cell(common.manifest(), cell_name)
    _, traffic, _ = common.cell_files(cell)
    training = traffic["entry"] == "gpt_train"
    cfg = small_config(cell["config"], z_num=32 if training else 64)
    cfg["gpt"]["n_embd"] = 128  # K2's head size, 64
    traffic = dict(traffic, batch=4 if training else 2, frames=4, pool=3, check_rows=2,
                   warmup_frames=2, reference_micro=2, traced_steps=2)
    run = (gpt_train if training else generate).Run(cfg, traffic, 2**31 + 77, device,
                                                    trace=True)
    run.setup()
    run.window(0.0 if not training else 5.0)
    return cfg, run.readings()


@pytest.mark.gpu
def test_every_k2_kernel_joins_a_launch_inside_a_decode_step(small_config, cuda):
    """The program's spans and the card's trace on one clock: every K2
    kernel of the traced rollout links to a launch call that began inside a
    ``tokens.step`` span, each step holds one a layer, and every new
    metric of the cell reads a value."""
    cfg, r = _traced("bairhd.gen_b16", small_config, cuda)
    j = spans.joined(r)
    steps = j.launched_in("tokens.step")
    k2 = [sum(spans.K2 in op for _, _, op in ops) for ops in steps]
    total = sum(1 for _, _, op, _ in j.ops if spans.K2 in op)
    assert total == r["k2_launches"] == sum(k2) and set(k2) == {cfg["gpt"]["n_layer"]}
    values = {name: harness.read_metric(name, r) for name in NEW_GEN}
    print(f"shared clock: {total} K2 kernels of {len(steps)} decode steps, each joined to a "
          f"launch call inside its tokens.step span; {values}")
    assert all(v is not None for v in values.values()), values
    assert 0 <= values["tokens_idle_share.gen"] <= 100
    common.free_cuda()


@pytest.mark.gpu
def test_the_training_metrics_read_on_the_card(small_config, cuda):
    _, r = _traced("bairhd.gpt_train", small_config, cuda)
    values = {name: harness.read_metric(name, r) for name in NEW_TRAIN}
    print(f"training: {values}")
    assert values["adamw_ms.gpt_train"] > 0 and values["h2d_copies_per_step.gpt_train"] >= 0
    common.free_cuda()
