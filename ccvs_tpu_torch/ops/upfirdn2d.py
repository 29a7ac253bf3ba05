"""Upsample (zero-stuffing), FIR filter, downsample (counterpart of
``ccvs_tpu/ops/upfirdn2d.py``, StyleGAN2's ``upfirdn2d``), NHWC.

Zero-stuffing, (possibly negative) padding and a depthwise ``F.conv2d`` with
the flipped kernel; the JAX package expresses the same pipeline as one XLA
convolution. The depthwise convolution is differentiated by hand
(:class:`_DepthwiseConv`), so that R1's double backward stays a few
convolutions: PyTorch's own double backward of a grouped convolution runs
one convolution a channel.
"""

import numpy as np
import torch
import torch.nn.functional as F


def make_resample_kernel(k, gain=1.0, device=None):
    """Normalised 2D FIR kernel from a 1D or 2D tap list, fp32 (on the
    default device unless ``device`` is given)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / k.sum()
    return torch.as_tensor(k * gain, device=device)


class _DepthwiseConv(torch.autograd.Function):
    """``F.conv2d(t, k, stride, groups=C)`` with a kernel that takes no
    gradient; its input gradient is :class:`_DepthwiseConvT`, whose own
    gradient is this convolution again, so any order of derivative is a
    first-order convolution. The operations are those PyTorch's autograd
    runs for the first derivative."""

    @staticmethod
    def forward(ctx, t, k, stride):
        ctx.save_for_backward(t, k)
        ctx.stride = stride
        return F.conv2d(t, k, stride=stride, groups=k.shape[0])

    @staticmethod
    def backward(ctx, g):
        t, k = ctx.saved_tensors
        return _DepthwiseConvT.apply(g, t, k, ctx.stride), None, None


class _DepthwiseConvT(torch.autograd.Function):
    """The input gradient of :class:`_DepthwiseConv` for output gradient
    ``g`` (``t`` gives the input's shape and layout)."""

    @staticmethod
    def forward(ctx, g, t, k, stride):
        ctx.save_for_backward(k)
        ctx.stride = stride
        return torch.ops.aten.convolution_backward(
            g, t, k, None, stride, [0, 0], [1, 1], False, [0, 0], k.shape[0],
            [True, False, False])[0]

    @staticmethod
    def backward(ctx, gg):
        k, = ctx.saved_tensors
        return _DepthwiseConv.apply(gg, k, ctx.stride), None, None, None


def _pair(v):
    return (v, v) if isinstance(v, int) else (v[1], v[0])


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """x ``(B, H, W, C)``; kernel ``(kh, kw)``; ``up``/``down`` an int or an
    ``(x, y)`` pair; ``pad`` ``(p0, p1)`` for both axes or ``(x0, x1, y0, y1)``.
    Returns ``(B, (H*up_y + y0 + y1 - kh)//down_y + 1, ..., C)``."""
    up_y, up_x = _pair(up)
    down_y, down_x = _pair(down)
    if len(pad) == 2:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad[0], pad[1], pad[0], pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    b, h, w, c = x.shape
    t = x.permute(0, 3, 1, 2)  # NCHW view
    if up_y > 1 or up_x > 1:
        stuffed = t.new_zeros(b, c, h * up_y, w * up_x)
        stuffed[:, :, ::up_y, ::up_x] = t
        t = stuffed
    t = F.pad(t, (pad_x0, pad_x1, pad_y0, pad_y1))
    # true convolution: flip the kernel for F.conv2d's cross-correlation
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, *k.shape)
    out = _DepthwiseConv.apply(t, k, (down_y, down_x))
    return out.permute(0, 2, 3, 1)


def blur(x, kernel, pad):
    """FIR blur, no resampling."""
    return upfirdn2d(x, kernel, pad=pad)


def upsample2x(x, kernel):
    """2x upsample with FIR smoothing."""
    factor = 2
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * factor**2, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2x(x, kernel):
    """2x downsample with FIR anti-aliasing."""
    factor = 2
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, down=factor, pad=((p + 1) // 2, p // 2))
