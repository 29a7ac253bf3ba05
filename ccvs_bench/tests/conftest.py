import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def small(name, z_num=32, top_k=8):
    """Configuration ``name`` at a CPU test's size: 8 channels at the first
    resolution, its own number of resolutions down to 8 x 8 latents, a
    2-layer GPT of width 32 over 4 frames."""
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    nres = len(cfg["ae"]["necf_mult"])
    cfg["ae"].update(necf=8, z_size=16, z_num=z_num, max_dim=8 << (nres - 1), skip_memory=3,
                     skip_context=[1, 2, 3])
    cfg["gpt"].update(n_layer=2, n_head=2, n_embd=32, z_num=z_num, z_len=256, num_blocks=4,
                      top_k=top_k)
    return copy.deepcopy(cfg)


@pytest.fixture
def small_config():
    return small


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
