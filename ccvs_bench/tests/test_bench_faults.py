"""A run driven past the harness's look for a chip, at a CPU test's size,
with the timed path broken underneath: ``correct`` comes out false under
the cell's own limits, once for each fault the cell can have (a step that
returns its state unchanged, half of the batch left out, a token or an
answer altered where it is produced). One cell has no chips to exchange
between, so that fault has no case."""

import time

import pytest

from ccvs_bench import common, harness
from ccvs_bench.entries import generate, gpt_train

CASES = [("bairhd.gpt_train", f) for f in gpt_train.FAULTS] + \
    [("bairhd.gen_b16", f) for f in generate.FAULTS]


def small_run(cell_name, fault, small_config):
    cell = harness.find_cell(common.manifest(), cell_name)
    _, traffic, limits = common.cell_files(cell)
    training = cell_name.endswith("gpt_train")
    cfg = small_config(cell["config"], z_num=32 if training else 64)
    traffic = dict(traffic, batch=4 if training else 2, frames=4, pool=3, check_rows=2,
                   warmup_frames=2, reference_micro=2)
    entry = gpt_train if training else generate
    run = entry.Run(cfg, traffic, 2**31 + 12345, "cpu", fault=fault)
    return harness.measure(run, 0.0, limits, time.perf_counter())


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, small_config):
    out = small_run(cell, fault, small_config)
    assert not out["correct"], out["checks"]
