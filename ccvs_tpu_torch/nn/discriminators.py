"""GAN discriminators (counterpart of ``ccvs_tpu/nn/discriminators.py``):
the StyleGAN2 image discriminator, the 3D-conv video discriminator and the
latent-feature discriminator, NHWC / NTHWC.

The minibatch-stddev groups are formed within the global batch: with
``data_axis`` set (a data-parallel trainer sets it) the features are first
gathered over the mesh's data axis, as the JAX package's GSPMD program
computes the stddev of the whole batch at every mesh size (the reference
forms the groups within each GPU's batch). Flattening before ``fc1`` goes
through the (C, H, W) order of the reference's NCHW tensors, which ``fc1``'s
weight was laid out for. Frames are ``max_dim x int(max_dim *
aspect_ratio)``: the image and video discriminators end at ``4 x int(4 *
aspect_ratio)``.
"""

import math

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import (ConvLayer3D, ConvLayerD, EqualLinear, ResBlock3D,
                                      ResBlockD, flatten_vid, minibatch_stddev,
                                      minibatch_stddev_3d)


def _avg_pool2x(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _channel_major(out):
    """``(B, ..., C)`` -> ``(B, C * ...)``: the reference's NC... flattening."""
    return out.movedim(-1, 1).reshape(out.shape[0], -1)


class ImageDiscriminator(nn.Module):
    """StyleGAN2 image discriminator: a 1x1 conv, a residual downsampling
    block per resolution down to 4 x int(4 * aspect_ratio), the
    minibatch-stddev channel, a 3x3
    conv and two linear layers. ``(B, H, W, 3)`` -> ``(B, 1)``."""

    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.data_axis = None  # parallel.mesh.DataAxis of a data-parallel trainer
        self.cfg = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        ndcf, mult = cfg.ndcf, cfg.ndcf_mult
        final_res = int(math.log2(cfg.z_shape[0])) - cfg.downsample_dis_num + len(mult) - 1
        block_in = block_out = ndcf * mult[0]
        self.conv0 = ConvLayerD(3 * cfg.n_consecutive_dis, block_in, 1, **kw)
        self.n_res = final_res - 2
        for i in range(1, final_res - 1):
            if i < len(mult):
                block_out = ndcf * mult[i]
            self.add_module(f"res{i}", ResBlockD(block_in, block_out, **kw))
            block_in = block_out
        self.final_conv = ConvLayerD(block_in + 1, block_in, 3, **kw)
        self.fc1 = EqualLinear(block_in * 4 * int(4 * cfg.aspect_ratio), block_in,
                               activation="fused_lrelu", **kw)
        self.fc2 = EqualLinear(block_in, 1, **kw)

    def forward(self, x):
        cfg = self.cfg
        n = cfg.n_consecutive_dis
        if n > 1:
            # n consecutive frames stacked on the channels, frame-minor
            b, h, w, c = x.shape
            x = x.reshape(b // n, n, h, w, c).movedim(1, -2).reshape(b // n, h, w, n * c)
        for _ in range(cfg.downsample_dis_num):
            x = _avg_pool2x(x)
        out = self.conv0(x)
        for i in range(1, self.n_res + 1):
            out = getattr(self, f"res{i}")(out)
        out = self.final_conv(minibatch_stddev(out, cfg.stddev_group, axis=self.data_axis))
        return self.fc2(self.fc1(_channel_major(out)))


class VideoDiscriminator(nn.Module):
    """3D-conv video discriminator: residual blocks that halve the frame and,
    while more than 2 frames are left, take 2 frames off. ``(B, T, H, W,
    3)`` -> ``(B, 1)``."""

    def __init__(self, cfg, vid_len, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.data_axis = None  # parallel.mesh.DataAxis of a data-parallel trainer
        self.cfg = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        ndcf, mult = cfg.ndcf, cfg.ndcf_mult
        final_res = int(math.log2(cfg.z_shape[0])) - cfg.downsample_vdis_num + len(mult) - 1
        block_in = block_out = ndcf * mult[0]
        self.conv0 = ConvLayer3D(3, block_in, 1, **kw)
        len_t = vid_len
        self.n_res = final_res - 2
        for i in range(1, final_res - 1):
            if i < len(mult):
                block_out = ndcf * mult[i]
            reduce_t = len_t > 2
            self.add_module(f"res{i}", ResBlock3D(block_in, block_out, reduce_t=reduce_t, **kw))
            if reduce_t:
                len_t -= 2
            block_in = block_out
        self.final_conv = ConvLayer3D(block_in + 1, block_in, 3, **kw)
        self.fc1 = EqualLinear(block_in * 4 * int(4 * cfg.aspect_ratio) * len_t, block_in,
                               activation="fused_lrelu", **kw)
        self.fc2 = EqualLinear(block_in, 1, **kw)

    def forward(self, x):
        if self.cfg.downsample_vdis_num > 0:
            b, t = x.shape[:2]
            xf = x.reshape(b * t, *x.shape[2:])
            for _ in range(self.cfg.downsample_vdis_num):
                xf = _avg_pool2x(xf)
            x = xf.reshape(b, t, *xf.shape[1:])
        out = self.conv0(x)
        for i in range(1, self.n_res + 1):
            out = getattr(self, f"res{i}")(out)
        out = self.final_conv(minibatch_stddev_3d(out, 4, axis=self.data_axis))
        return self.fc2(self.fc1(_channel_major(out)))


class FeatureDiscriminator(nn.Module):
    """Discriminator of the quantized latents ``(B[, T], h, w, z_size)`` ->
    ``(B*T, 1)``."""

    def __init__(self, cfg, dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.data_axis = None  # parallel.mesh.DataAxis of a data-parallel trainer
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.conv0 = ConvLayerD(cfg.z_size, 128, 1, **kw)
        h, w = cfg.z_shape
        self.n_res = 0
        while h > 1 and w > 1:
            self.add_module(f"res{self.n_res}", ResBlockD(128, 128, **kw))
            h, w, self.n_res = h // 2, w // 2, self.n_res + 1
        self.final_conv = ConvLayerD(129, 128, 3, **kw)
        self.fc1 = EqualLinear(128 * h * w, 128, activation="fused_lrelu", **kw)
        self.fc2 = EqualLinear(128, 1, **kw)

    def forward(self, x):
        out = self.conv0(flatten_vid(x)[0])
        for i in range(self.n_res):
            out = getattr(self, f"res{i}")(out)
        out = self.final_conv(minibatch_stddev(out, 4, axis=self.data_axis))
        return self.fc2(self.fc1(_channel_major(out)))
