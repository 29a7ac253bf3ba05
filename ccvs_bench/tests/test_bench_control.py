"""The control on the card: the reference computed in fp8, put in the
program's place, fails one of the cell's compared numbers under the cell's
own limits, on three seeds, at the configuration's widths with a smaller
batch (the readings the limits were set from are ``calibrate.py``'s, at the
cell's own size)."""

import pytest

from ccvs_bench import common, harness
from ccvs_bench.entries import generate, gpt_train

CELLS = ["bairhd.gpt_train", "kinetics600.gpt_train", "bairhd.gen_b16"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_control_is_not_correct(cell_name, seed, cuda):
    cell = harness.find_cell(common.manifest(), cell_name)
    cfg, traffic, limits = common.cell_files(cell)
    training = traffic["entry"] == "gpt_train"
    traffic = dict(traffic, batch=4 if training else 2, check_rows=2)
    run = (gpt_train if training else generate).Run(cfg, traffic, seed, cuda)
    run.setup()
    run.window(0.0)
    run.free()
    numbers = run.judge(run.reference("fp8"))
    assert any(v > limits[k] for k, v in numbers.items()), numbers
    common.free_cuda()
