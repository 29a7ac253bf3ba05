"""SkipGAN frame encoder (counterpart of ``ccvs_tpu/nn/encoder.py``), NHWC."""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import ConvLayerAE, ResBlockAE, flatten_vid, unflatten_vid


class SkipEncoder(nn.Module):
    """1x1 in-conv, a downsampling ResBlock per resolution, 1x1 out-conv to the
    latent size. The first ``inter_p`` of the channels at every resolution are
    the context ("inter") features of the flow-warping decoder."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        chans = cfg.enc_channels
        self.add_module("block0", ConvLayerAE(3, chans[0], 1, dtype=dtype))
        for i in range(1, cfg.num_resolutions):
            self.add_module(f"block{i}", ResBlockAE(chans[i - 1], chans[i], downsample=True,
                                                    dtype=dtype))
        self.add_module(f"block{cfg.num_resolutions}",
                        ConvLayerAE(chans[-1], cfg.z_size, 1, dtype=dtype))

    def forward(self, x):
        """x ``(B[, T], H, W, 3)`` -> ``(z, inters)``: z ``(B[, T], h, w,
        z_size)`` and the context features per resolution, finest first."""
        cfg = self.cfg
        x, t = flatten_vid(x)
        sizes = cfg.inter_sizes_enc
        out = self.block0(x)
        inters = [out[..., :sizes[0]]]
        for i in range(1, cfg.num_resolutions):
            out = getattr(self, f"block{i}")(out)
            inters.append(out[..., :sizes[i]])
        out = getattr(self, f"block{cfg.num_resolutions}")(out)
        return unflatten_vid(out, t), [unflatten_vid(f, t) for f in inters]
