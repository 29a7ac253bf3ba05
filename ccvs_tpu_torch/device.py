"""Device selection for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """The CUDA device unless the caller asks for another one (``cuda``
    names the current one, with its index); a missing GPU raises instead of
    falling back to the CPU.

    Also pins fp32 matrix products and convolutions to full fp32: PyTorch
    runs fp32 convolutions in TF32 on the GPU by default, which keeps about
    three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
