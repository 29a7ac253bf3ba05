"""Equalized-learning-rate blocks of the autoencoder (counterpart of the
autoencoder part of ``ccvs_tpu/nn/layers.py``), NHWC.

Parameters keep the JAX package's names and torch layouts (conv
``weight (O, I, kh, kw)``, linear ``weight (O, I)``). Each module holds its
parameters in its ``dtype`` and computes in it; the FIR filters stay fp32.
The discriminator blocks come with the training slice.
"""

import math

import torch
from torch import nn

from ccvs_tpu_torch.ops.convops import conv2d, conv_transpose2d
from ccvs_tpu_torch.ops.fused_act import fused_leaky_relu, leaky_relu
from ccvs_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d, upsample2x

BLUR_KERNEL = (1, 3, 3, 1)


class EqualConv2d(nn.Module):
    """Conv with runtime weight scale ``1/sqrt(fan_in)`` (weights drawn N(0, 1))."""

    def __init__(self, in_channel, out_channel, kernel_size, stride=1, padding=0,
                 use_bias=True, transpose=False, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_channel, dtype=dtype)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride, self.padding, self.transpose, self.dtype = stride, padding, transpose, dtype

    def forward(self, x, shared=None, k=1):
        """``x`` ``(N, H, W, C)``. With ``shared`` ``(B, H, W, C0)``, ``x`` is
        the per-item tail of the logical input ``concat([tile(shared, k), x])``
        (N = B*k, b-major): by conv linearity the shared block is convolved
        once per batch element and repeated."""
        w, b = self.weight * self.scale, self.bias
        x = x.to(self.dtype)
        if self.transpose:
            # the reference transposes the (O, I, k, k) weight at call time
            return conv_transpose2d(x, w.transpose(0, 1), b, stride=self.stride,
                                    padding=self.padding)
        if shared is not None:
            c0 = shared.shape[-1]
            ys = conv2d(shared.to(self.dtype), w[:, :c0], None, stride=self.stride,
                        padding=self.padding)
            out = ys.repeat_interleave(k, dim=0) + conv2d(
                x, w[:, c0:], b, stride=self.stride, padding=self.padding)
        else:
            out = conv2d(x, w, b, stride=self.stride, padding=self.padding)
        return out.to(self.dtype)


class EqualLinear(nn.Module):
    """Equalized linear layer (weights drawn N(0, 1/lr_mul))."""

    def __init__(self, in_dim, out_dim, use_bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=dtype))
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init), dtype=dtype))
                     if use_bias else None)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul, self.activation, self.dtype = lr_mul, activation, dtype

    def forward(self, x):
        w = self.weight * self.scale
        b = None if self.bias is None else self.bias * self.lr_mul
        out = x.to(self.dtype) @ w.T
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, b)
        return out if b is None else out + b


class Blur(nn.Module):
    """FIR blur, computed in fp32 whatever the input dtype."""

    def __init__(self, pad, upsample_factor=1, kernel=BLUR_KERNEL):
        super().__init__()
        self.pad = pad
        self.register_buffer("kernel", make_resample_kernel(kernel, gain=upsample_factor**2),
                             persistent=False)

    def forward(self, x):
        return upfirdn2d(x.float(), self.kernel.float(), pad=self.pad).to(x.dtype)


class ConvLayerAE(nn.Module):
    """[Blur] -> EqualConv -> [Blur] -> LeakyReLU(0.1), no gain."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False, upsample=False,
                 use_bias=True, activate=True, dtype=torch.float32):
        super().__init__()
        blur_len = len(BLUR_KERNEL)
        self.down_blur = self.up_blur = None
        if downsample:
            p = (blur_len - 2) + (kernel_size - 1)
            self.down_blur = Blur(pad=((p + 1) // 2, p // 2))
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=2,
                                    use_bias=use_bias, dtype=dtype)
        elif upsample:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=2,
                                    use_bias=use_bias, transpose=True, dtype=dtype)
            p = (blur_len - 2) - (kernel_size - 1)
            self.up_blur = Blur(pad=((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2)
        else:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size,
                                    padding=kernel_size // 2, use_bias=use_bias, dtype=dtype)
        self.activate = activate

    def forward(self, x, shared=None, k=1):
        if shared is not None and (self.down_blur is not None or self.up_blur is not None):
            raise ValueError("shared= is supported on the stride-1 path only")
        if self.down_blur is not None:
            x = self.down_blur(x)
        x = self.conv(x, shared=shared, k=k)
        if self.up_blur is not None:
            x = self.up_blur(x)
        return leaky_relu(x, 0.1) if self.activate else x


class ResBlockAE(nn.Module):
    """Residual down/up block."""

    def __init__(self, in_channel, out_channel, downsample=False, upsample=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvLayerAE(in_channel, in_channel, 3, dtype=dtype)
        self.conv2 = ConvLayerAE(in_channel, out_channel, 3, downsample=downsample,
                                 upsample=upsample, dtype=dtype)
        self.skip = ConvLayerAE(in_channel, out_channel, 1, downsample=downsample,
                                upsample=upsample, activate=False, use_bias=False, dtype=dtype)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) * (1.0 / math.sqrt(2.0))


class ToRGB(nn.Module):
    """Skip-RGB head: a 1x1 conv plus bias, adding the 2x-upsampled previous RGB."""

    def __init__(self, in_channel, dtype=torch.float32):
        super().__init__()
        self.conv = ConvLayerAE(in_channel, 3, 1, activate=False, dtype=dtype)
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, 3, dtype=dtype))
        self.register_buffer("kernel", make_resample_kernel(BLUR_KERNEL), persistent=False)

    def forward(self, x, skip=None):
        out = self.conv(x)
        out = out + self.bias
        if skip is not None:
            out = out + upsample2x(skip.float(), self.kernel.float()).to(out.dtype)
        return out


def flatten_vid(x):
    """``(B, T, H, W, C)`` -> ``(B*T, H, W, C)`` and T (None for 4D input)."""
    if x.ndim == 5:
        b, t = x.shape[:2]
        return x.reshape(b * t, *x.shape[2:]), t
    return x, None


def unflatten_vid(x, t):
    if t is None:
        return x
    return x.reshape(x.shape[0] // t, t, *x.shape[1:])
