"""Upsample (zero-stuffing), FIR filter, downsample (counterpart of
``ccvs_tpu/ops/upfirdn2d.py``, StyleGAN2's ``upfirdn2d``), NHWC.

Zero-stuffing, (possibly negative) padding and a depthwise ``F.conv2d`` with
the flipped kernel; the JAX package expresses the same pipeline as one XLA
convolution.
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
    out = F.conv2d(t, k, stride=(down_y, down_x), groups=c)
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
