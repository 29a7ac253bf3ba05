"""Equalized-learning-rate blocks of the autoencoder and the discriminators
(counterpart of ``ccvs_tpu/nn/layers.py``), NHWC / NTHWC.

Parameters keep the JAX package's names and torch layouts (conv
``weight (O, I, kh, kw)`` / ``(O, I, kt, kh, kw)``, linear ``weight (O,
I)``). Each module computes in its ``dtype`` and holds its parameters in
``param_dtype`` (default: ``dtype``), cast where they are used as flax's
``param_dtype`` / ``dtype`` do: serving holds them in the compute dtype, so
the casts are no-ops; training holds fp32 parameters under bf16 compute, as
the JAX package creates every parameter in fp32. The FIR filters stay fp32.
"""

import math

import torch
from torch import nn

from ccvs_tpu_torch.ops.convops import conv2d, conv3d, conv_transpose2d
from ccvs_tpu_torch.ops.fused_act import fused_leaky_relu, leaky_relu
from ccvs_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d, upsample2x

BLUR_KERNEL = (1, 3, 3, 1)


def as_dtype(p, dtype):
    """``p`` in ``dtype``; no operation where it already is (serving)."""
    return p if p is None or p.dtype == dtype else p.to(dtype)


class EqualConv2d(nn.Module):
    """Conv with runtime weight scale ``1/sqrt(fan_in)`` (weights drawn N(0, 1))."""

    def __init__(self, in_channel, out_channel, kernel_size, stride=1, padding=0,
                 use_bias=True, transpose=False, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size, dtype=pdt))
        self.bias = nn.Parameter(torch.zeros(out_channel, dtype=pdt)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride, self.padding, self.transpose, self.dtype = stride, padding, transpose, dtype

    def forward(self, x, shared=None, k=1):
        """``x`` ``(N, H, W, C)``. With ``shared`` ``(B, H, W, C0)``, ``x`` is
        the per-item tail of the logical input ``concat([tile(shared, k), x])``
        (N = B*k, b-major): by conv linearity the shared block is convolved
        once per batch element and repeated."""
        w, b = as_dtype(self.weight * self.scale, self.dtype), as_dtype(self.bias, self.dtype)
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
                 activation=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=pdt))
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init), dtype=pdt))
                     if use_bias else None)
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul, self.activation, self.dtype = lr_mul, activation, dtype
        self.bias_init = float(bias_init)

    def forward(self, x):
        w = as_dtype(self.weight * self.scale, self.dtype)
        b = None if self.bias is None else as_dtype(self.bias * self.lr_mul, self.dtype)
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
                 use_bias=True, activate=True, dtype=torch.float32, param_dtype=None):
        super().__init__()
        blur_len = len(BLUR_KERNEL)
        self.down_blur = self.up_blur = None
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype)
        if downsample:
            p = (blur_len - 2) + (kernel_size - 1)
            self.down_blur = Blur(pad=((p + 1) // 2, p // 2))
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=2, **kw)
        elif upsample:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=2,
                                    transpose=True, **kw)
            p = (blur_len - 2) - (kernel_size - 1)
            self.up_blur = Blur(pad=((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2)
        else:
            self.conv = EqualConv2d(in_channel, out_channel, kernel_size,
                                    padding=kernel_size // 2, **kw)
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
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv1 = ConvLayerAE(in_channel, in_channel, 3, **kw)
        self.conv2 = ConvLayerAE(in_channel, out_channel, 3, downsample=downsample,
                                 upsample=upsample, **kw)
        self.skip = ConvLayerAE(in_channel, out_channel, 1, downsample=downsample,
                                upsample=upsample, activate=False, use_bias=False, **kw)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) * (1.0 / math.sqrt(2.0))


class ToRGB(nn.Module):
    """Skip-RGB head: a 1x1 conv plus bias, adding the 2x-upsampled previous RGB."""

    def __init__(self, in_channel, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.conv = ConvLayerAE(in_channel, 3, 1, activate=False, dtype=dtype,
                                param_dtype=param_dtype)
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, 3, dtype=param_dtype or dtype))
        self.register_buffer("kernel", make_resample_kernel(BLUR_KERNEL), persistent=False)

    def forward(self, x, skip=None):
        out = self.conv(x)
        out = out + as_dtype(self.bias, out.dtype)
        if skip is not None:
            out = out + upsample2x(skip.float(), self.kernel.float()).to(out.dtype)
        return out


class EqualConv3d(nn.Module):
    """3D equalized conv, NTHWC (weights drawn N(0, 1))."""

    def __init__(self, in_channel, out_channel, kernel_size, stride=(1, 1, 1),
                 padding=(0, 0, 0), use_bias=True, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pdt = param_dtype or dtype
        self.weight = nn.Parameter(torch.empty(out_channel, in_channel, *kernel_size, dtype=pdt))
        self.bias = nn.Parameter(torch.zeros(out_channel, dtype=pdt)) if use_bias else None
        self.scale = 1.0 / math.sqrt(in_channel * math.prod(kernel_size))
        self.stride, self.padding, self.dtype = tuple(stride), tuple(padding), dtype

    def forward(self, x):
        w = as_dtype(self.weight * self.scale, self.dtype)
        return conv3d(x.to(self.dtype), w, as_dtype(self.bias, self.dtype), stride=self.stride,
                      padding=self.padding)


class ConvLayerD(nn.Module):
    """Discriminator conv layer: [Blur] -> EqualConv -> FusedLeakyReLU (slope
    0.2, gain sqrt(2)); when activated the bias is the activation's
    (``act_bias``)."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False, use_bias=True,
                 activate=True, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.blur = None
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (kernel_size - 1)
            self.blur = Blur(pad=((p + 1) // 2, p // 2))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv2d(in_channel, out_channel, kernel_size, stride=stride,
                                padding=padding, use_bias=use_bias and not activate,
                                dtype=dtype, param_dtype=param_dtype)
        self.activate = activate
        self.act_bias = (nn.Parameter(torch.zeros(out_channel, dtype=param_dtype or dtype))
                         if activate and use_bias else None)

    def forward(self, x):
        if self.blur is not None:
            x = self.blur(x)
        x = self.conv(x)
        if self.activate:
            x = fused_leaky_relu(x, as_dtype(self.act_bias, x.dtype))
        return x


class ResBlockD(nn.Module):
    """Discriminator residual downsampling block."""

    def __init__(self, in_channel, out_channel, downsample=True, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv1 = ConvLayerD(in_channel, in_channel, 3, **kw)
        self.conv2 = ConvLayerD(in_channel, out_channel, 3, downsample=downsample, **kw)
        self.skip = ConvLayerD(in_channel, out_channel, 1, downsample=downsample,
                               activate=False, use_bias=False, **kw)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) * (1.0 / math.sqrt(2.0))


class ConvLayer3D(nn.Module):
    """Video-discriminator conv layer, NTHWC: [per-frame Blur] -> EqualConv3d
    (spatial stride 2 when downsampling; with ``reduce_t`` no time padding,
    so a time kernel of 3 takes 2 frames off) -> FusedLeakyReLU."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False, use_bias=True,
                 activate=True, reduce_t=False, dtype=torch.float32, param_dtype=None):
        super().__init__()
        ks = kernel_size
        kernel = (ks, ks, ks) if isinstance(ks, int) else tuple(ks)
        k_t, k = kernel[0], kernel[-1]
        self.blur = None
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (k - 1)
            self.blur = Blur(pad=((p + 1) // 2, p // 2))
            stride = (1, 2, 2)
            padding = (0, 0, 0) if reduce_t else (k_t // 2, 0, 0)
        else:
            stride, padding = (1, 1, 1), (k // 2, k // 2, k // 2)
        self.conv = EqualConv3d(in_channel, out_channel, kernel, stride=stride, padding=padding,
                                use_bias=use_bias and not activate, dtype=dtype,
                                param_dtype=param_dtype)
        self.activate = activate
        self.act_bias = (nn.Parameter(torch.zeros(out_channel, dtype=param_dtype or dtype))
                         if activate and use_bias else None)

    def forward(self, x):
        if self.blur is not None:
            b, t = x.shape[:2]
            xf = self.blur(x.reshape(b * t, *x.shape[2:]))
            x = xf.reshape(b, t, *xf.shape[1:])
        x = self.conv(x)
        if self.activate:
            x = fused_leaky_relu(x, as_dtype(self.act_bias, x.dtype))
        return x


class ResBlock3D(nn.Module):
    """3D residual downsampling block; with ``reduce_t`` it takes 2 frames off."""

    def __init__(self, in_channel, out_channel, reduce_t=False, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv1 = ConvLayer3D(in_channel, in_channel, 3, **kw)
        self.conv2 = ConvLayer3D(in_channel, out_channel, 3, downsample=True, reduce_t=reduce_t,
                                 **kw)
        self.skip = ConvLayer3D(in_channel, out_channel, (3, 1, 1) if reduce_t else 1,
                                downsample=True, activate=False, use_bias=False,
                                reduce_t=reduce_t, **kw)

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return (out + self.skip(x)) * (1.0 / math.sqrt(2.0))


def minibatch_stddev(x, group_size, stddev_feat=1):
    """Minibatch standard-deviation feature, NHWC: item ``i`` is grouped with
    the items ``i mod (B / group)`` apart (the reference's ``view(group,
    -1, ...)``), the std over each group, averaged over (h, w, c), appended
    as a channel."""
    b, h, w, c = x.shape
    group = min(b, group_size)
    y = x.reshape(group, -1, h, w, stddev_feat, c // stddev_feat).float()
    std = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
    std = std.mean(dim=(1, 2, 4), keepdim=True).squeeze(4)  # (n, 1, 1, sf)
    return torch.cat([x, std.repeat(group, h, w, 1).to(x.dtype)], dim=-1)


def minibatch_stddev_3d(x, group_size, stddev_feat=1):
    """:func:`minibatch_stddev` of NTHWC videos."""
    b, t, h, w, c = x.shape
    group = min(b, group_size)
    y = x.reshape(group, -1, t, h, w, stddev_feat, c // stddev_feat).float()
    std = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
    std = std.mean(dim=(1, 2, 3, 5), keepdim=True).squeeze(5)  # (n, 1, 1, 1, sf)
    return torch.cat([x, std.repeat(group, t, h, w, 1).to(x.dtype)], dim=-1)


@torch.no_grad()
def init_equalized(module, generator):
    """flax's initializers, seeded: equalized conv weights N(0, 1), linear
    weights N(0, 1 / lr_mul), grouped upsamplers N(0, 0.02) (any module with
    ``init_std``), deformable conv weights N(0, ``deform_std``); biases 0, or
    a linear layer's ``bias_init``. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (EqualConv2d, EqualConv3d)):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, EqualLinear):
            m.weight.normal_(0.0, 1.0 / m.lr_mul, generator=generator)
            if m.bias is not None:
                m.bias.fill_(m.bias_init)
            continue
        elif hasattr(m, "init_std"):
            m.weight.normal_(0.0, m.init_std, generator=generator)
        elif hasattr(m, "deform_std"):  # the decoder's deformable conv (He normal)
            m.deform_weight.normal_(0.0, m.deform_std, generator=generator)
            m.deform_bias.zero_()
        for name in ("bias", "act_bias"):
            p = getattr(m, name, None)
            if isinstance(p, nn.Parameter):
                p.zero_()
    return module


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
