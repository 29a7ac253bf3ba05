"""The FLOP counts of ``counts/`` against ``FlopCounterMode`` over the plain
reference, at small sizes on the CPU, and K1's count of the algorithm's
work."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ccvs_bench import weights
from ccvs_bench.counts import kernels, model
from ccvs_bench.reference import ae as ref_ae
from ccvs_bench.reference import gpt as ref_gpt
from ccvs_bench.reference.precision import exact


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["bairhd", "kinetics600"])
def test_gpt_forward_count(name, small_config):
    gpt = small_config(name)["gpt"]
    p = {k: v.float() for k, v in weights.make_gpt(gpt, 1, "cpu").items()}
    code = torch.randint(0, gpt["z_num"], (3, 100))
    assert counted(lambda: ref_gpt.forward(p, gpt, code, exact)) == model.gpt_forward(gpt, 3, 100)


@pytest.mark.parametrize("name", ["bairhd", "kinetics600"])
def test_autoencoder_counts(name, small_config):
    ae = small_config(name)["ae"]
    p = {k: v.float() for k, v in weights.make_ae(ae, 1, "cpu").items()}
    clip = weights.smooth_clips(weights.generator("cpu", 1, 9), (2, 5, ae["max_dim"],
                                                                 ae["max_dim"], 3), "cpu")
    frames = clip.reshape(-1, *clip.shape[2:]).permute(0, 3, 1, 2)
    assert counted(lambda: ref_ae.encode(p, ae, frames, exact)) == model.encode(ae, 10)
    codes = torch.randint(0, ae["z_num"], (2, 5, 64))
    got = counted(lambda: ref_ae.decode_video(p, ae, codes, frames[::5], exact))
    assert got == model.decode_video(ae, 2, 5)


def test_k1_counts_the_algorithm_once():
    flops, n_bytes = kernels.k1_work(16384, 1024, 512)
    assert flops == 2 * 16384 * 1024 * 512
    assert n_bytes == 4 * (16384 * 512 + 1024 * 512 + 16384)
    assert kernels.bound_s(flops, n_bytes, kernels.PEAK_TF32) == flops / kernels.PEAK_TF32
