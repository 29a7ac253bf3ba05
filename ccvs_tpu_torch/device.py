"""Device selection for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller asks for another one; a missing GPU
    raises instead of falling back to the CPU.

    Also pins fp32 matrix products and convolutions to full fp32: PyTorch
    runs fp32 convolutions in TF32 on the GPU by default, which keeps about
    three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
