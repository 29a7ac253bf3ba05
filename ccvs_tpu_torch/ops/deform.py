"""Deformable 3x3 convolution at a per-pixel flow offset (counterpart of
``ccvs_tpu/ops/deform.py``), NHWC.

Every tap shares the pixel's offset (the estimated flow), so the op is nine
bilinear warps, each shifted by its tap's position, combined by the taps'
1x1 convolutions. It is plain PyTorch, as it is plain XLA in the JAX
package: :func:`~ccvs_tpu_torch.ops.warp.backwarp` (``grid_sample``) gives
the gradients with respect to the input and to the offset.
"""

import torch

from ccvs_tpu_torch.ops.convops import conv2d
from ccvs_tpu_torch.ops.warp import backwarp


def deform_conv3x3(x, flow, weight, bias=None):
    """3x3 deformable conv with a shared per-pixel offset.

    Args:
      x: ``(B, H, W, C)``.
      flow: ``(B, H, W, 2)`` pixel offsets (``[..., 0]`` = x).
      weight: ``(O, C, 3, 3)``; bias: optional ``(O,)``.

    Returns:
      ``(B, H, W, O)``: the sum over taps ``(ky, kx)`` (ky outer, kx inner,
      as the JAX package sums them) of ``W[:, :, ky+1, kx+1] . sample(x, p +
      (kx, ky) + flow(p))``.
    """
    _, h, w, _ = x.shape
    # backwarp keeps the reference's normalisation (a unit of flow moves
    # W/(W-1) pixels); a deformable conv's offsets are pixels. The JAX
    # package rounds these units to the flow's dtype before multiplying.
    ux = float(torch.tensor((w - 1) / w, dtype=flow.dtype))
    uy = float(torch.tensor((h - 1) / h, dtype=flow.dtype))
    fx, fy = flow[..., 0], flow[..., 1]
    out = None
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            off = torch.stack([(fx + kx) * ux, (fy + ky) * uy], dim=-1)
            term = conv2d(backwarp(x, off), weight[:, :, ky + 1, kx + 1, None, None])
            out = term if out is None else out + term
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
