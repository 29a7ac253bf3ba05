"""Operand rounding of the reference's products.

``exact`` leaves every operand as it is: the reference proper, in fp32 with
TF32 off (:func:`fp32_mode`). ``fp8`` rounds each operand of each product
to float8 e4m3 under one scale a tensor (its largest magnitude to 448), the
usual recipe of an fp8 path: the control, one precision below the bf16 that
the configurations compute in. The rounding passes the gradient straight
through, so a control training step differentiates the rounded forward.
"""

import contextlib

import torch

E4M3_MAX = 448.0


def exact(x):
    return x


def fp8(x):
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    r = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (r - x).detach()


def bf16(x):
    """The operand rounded to bf16 (a witness of the program's precision, not
    a control)."""
    if not x.is_floating_point():
        return x
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


ROUNDING = {"fp32": exact, "fp8": fp8, "bf16": bf16}


@contextlib.contextmanager
def fp32_mode():
    """fp32 products and convolutions without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
