"""SkipGAN frame encoder (counterpart of ``ccvs_tpu/nn/encoder.py``), NHWC."""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import ConvLayerAE, ResBlockAE, flatten_vid, unflatten_vid


class SkipEncoder(nn.Module):
    """1x1 in-conv, a downsampling ResBlock per resolution, 1x1 out-conv to the
    latent size. The first ``inter_p`` of the channels at every resolution are
    the context ("inter") features of the flow-warping decoder. ``mode``
    ``"layout"`` encodes one-hot segmentations of ``cfg.layout_size``
    classes instead of RGB (the layout twin). With ``cfg.normalize_out`` the
    latent is divided by its norm over channels."""

    def __init__(self, cfg, mode="rgb", dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        chans = cfg.enc_channels
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        in_size = cfg.layout_size if mode == "layout" else 3
        self.add_module("block0", ConvLayerAE(in_size, chans[0], 1, **kw))
        for i in range(1, cfg.num_resolutions):
            self.add_module(f"block{i}", ResBlockAE(chans[i - 1], chans[i], downsample=True,
                                                    **kw))
        self.add_module(f"block{cfg.num_resolutions}",
                        ConvLayerAE(chans[-1], cfg.z_size, 1, **kw))

    def forward(self, x):
        """x ``(B[, T], H, W, 3 | layout_size)`` -> ``(z, inters)``: z ``(B[, T], h, w,
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
        if cfg.normalize_out:  # divided by its channel norm, taken in fp32
            out = out / torch.linalg.vector_norm(out.float(), dim=-1, keepdim=True).to(out.dtype)
        return unflatten_vid(out, t), [unflatten_vid(f, t) for f in inters]
