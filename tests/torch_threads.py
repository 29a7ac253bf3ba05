"""The thread count of the port's CPU tests, free of JAX so that the test
files that import neither JAX nor ccvs_tpu can use it too."""

import pytest
import torch


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for a module's PyTorch work, then the previous
    count: the tier-1 run puts six test processes on the CPU's cores, and a
    process's default of one OpenMP thread a core oversubscribes them, which
    slows the many small operations of a small model's backward pass
    several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
