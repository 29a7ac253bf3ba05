"""Bias + leaky ReLU + scale (counterpart of ``ccvs_tpu/ops/fused_act.py``).
Channel-last: the bias broadcasts over the trailing axis."""

import torch

SQRT2 = 2.0**0.5


def leaky_relu(x, negative_slope=0.2):
    return torch.where(x >= 0, x, x * negative_slope)


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=SQRT2):
    """``leaky_relu(x + bias) * scale``."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    return leaky_relu(x, negative_slope) * scale
