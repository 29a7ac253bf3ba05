"""Convolutions on NHWC activations with torch-layout weights (counterpart
of ``ccvs_tpu/ops/convops.py``).

The JAX package leaves these to XLA; here they are ``F.conv2d`` /
``F.conv_transpose2d`` / ``F.conv3d``. An NHWC tensor is permuted to an NCHW view without a
copy (its strides are PyTorch's ``channels_last`` format, which cuDNN takes as
is), and the result is permuted back; an NTHWC video likewise to NCTHW
(``channels_last_3d``).
"""

import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, b=None, stride=1, padding=0, groups=1, dilation=1):
    """``F.conv2d`` semantics; x ``(B, H, W, I)``, w ``(O, I/groups, kh, kw)``."""
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding,
                          dilation=dilation, groups=groups))


def conv_transpose2d(x, w, b=None, stride=1, padding=0, groups=1):
    """``F.conv_transpose2d`` semantics; x ``(B, H, W, I)``, w ``(I, O/groups, kh, kw)``."""
    return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=stride, padding=padding,
                                    groups=groups))


def conv3d(x, w, b=None, stride=1, padding=0, groups=1):
    """``F.conv3d`` semantics; x ``(B, T, H, W, I)``, w ``(O, I/groups, kt, kh, kw)``."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=stride, padding=padding,
                    groups=groups).permute(0, 2, 3, 4, 1)
