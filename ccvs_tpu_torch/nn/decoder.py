"""SkipGAN decoder with the learnable optical-flow context module
(counterpart of ``ccvs_tpu/nn/decoder.py``), NHWC.

The ``k`` contexts are folded into the batch axis (b-major, k-minor); a
``ctx_mask (B, k)`` marks the valid context slots of a fixed-size FIFO. The
decoder features ``x`` are shared across the contexts, so every conv that
reads them computes their term once per batch element (exact by conv
linearity; the JAX package's ``shared_x_split``, its default).
"""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import ConvLayerAE, ResBlockAE, flatten_vid, unflatten_vid
from ccvs_tpu_torch.ops.convops import conv_transpose2d
from ccvs_tpu_torch.ops.correlation import local_correlation
from ccvs_tpu_torch.ops.fused_act import leaky_relu
from ccvs_tpu_torch.ops.warp import backwarp, backwarp_sampled


class GroupedUpsample(nn.Module):
    """Grouped 2x transposed conv (k=4, s=2, p=1, groups=C; weights drawn N(0, 0.02))."""

    def __init__(self, channels, out_channels=None, dtype=torch.float32):
        super().__init__()
        out_ch = out_channels or channels
        self.weight = nn.Parameter(torch.empty(channels, out_ch // channels, 4, 4, dtype=dtype))
        self.channels, self.dtype = channels, dtype

    def forward(self, x):
        return conv_transpose2d(x.to(self.dtype), self.weight, None, stride=2,
                                padding=1, groups=self.channels)


class Matching(nn.Module):
    """Cost-volume flow estimation."""

    def __init__(self, flow_mult, kernel, feat_size, corr_stride, first, dtype=torch.float32):
        super().__init__()
        self.flow_mult, self.corr_stride = flow_mult, corr_stride
        if not first:
            self.upsample_flow = GroupedUpsample(2, dtype=dtype)
            self.upsample_occ = GroupedUpsample(1, dtype=dtype)
        self.proj = (ConvLayerAE(feat_size, max(16, feat_size // 4), 1, dtype=dtype)
                     if feat_size > 16 else None)
        if corr_stride != 1:
            self.upsample_corr = GroupedUpsample(49, dtype=dtype)
        self.convs0 = ConvLayerAE(49, 128, 3, dtype=dtype)
        self.convs1 = ConvLayerAE(128, 64, 3, dtype=dtype)
        self.convs2 = ConvLayerAE(64, 32, 3, dtype=dtype)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, dtype=dtype)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, dtype=dtype)

    def forward(self, x, k, inter, flow, occ):
        """x ``(B, h, w, s)`` shared decoder features; inter, flow, occ
        ``(B*k, ...)``; flow and occ are None at the first block."""
        s = self.corr_stride
        if flow is not None:
            flow = self.upsample_flow(flow)
            occ = self.upsample_occ(occ)
            # the warped features feed only proj -> correlation, which reads
            # stride positions: warp just those (exact, the warp is per position)
            inter = backwarp_sampled(inter, flow * self.flow_mult, s)
        else:
            inter = inter[:, ::s, ::s]
        xc = x[:, ::s, ::s]
        if self.proj is not None:
            px, pi = self.proj(xc).repeat_interleave(k, dim=0), self.proj(inter)
        else:
            px, pi = xc.repeat_interleave(k, dim=0), inter
        # on the stride grid, stride-s correlation is stride 1 on the samples
        corr = leaky_relu(local_correlation(px.float(), pi.float()), 0.1).to(x.dtype)
        if s != 1:
            corr = self.upsample_corr(corr)
        feat = self.convs2(self.convs1(self.convs0(corr)))
        dflow, docc = self.flow_head(feat), self.occ_head(feat)
        flow = dflow if flow is None else flow + dflow
        occ = docc if occ is None else occ + docc
        return flow, occ


class Subpixel(nn.Module):
    """Subpixel flow refinement."""

    def __init__(self, flow_mult, kernel, feat_size, dtype=torch.float32):
        super().__init__()
        self.flow_mult = flow_mult
        self.convs0 = ConvLayerAE(2 * feat_size + 3, 128, 3, dtype=dtype)
        self.convs1 = ConvLayerAE(128, 64, 3, dtype=dtype)
        self.convs2 = ConvLayerAE(64, 32, 3, dtype=dtype)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, dtype=dtype)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, dtype=dtype)

    def forward(self, x, k, inter, flow, occ):
        warped = backwarp(inter, flow * self.flow_mult)
        rest = torch.cat([warped, flow, occ], dim=-1)
        feat = self.convs2(self.convs1(self.convs0(rest, shared=x, k=k)))
        return flow + self.flow_head(feat), occ + self.occ_head(feat)


class InterBlock(nn.Module):
    """Per-resolution context fusion: flow by matching + subpixel refinement,
    then a confidence-weighted average of the warped contexts."""

    def __init__(self, flow_mult, kernel, feat_size, corr_stride, first=False,
                 dtype=torch.float32):
        super().__init__()
        self.flow_mult = flow_mult
        self.matching = Matching(flow_mult, kernel, feat_size, corr_stride, first, dtype)
        self.subpixel = Subpixel(flow_mult, kernel, feat_size, dtype)

    def forward(self, x, inters, flows=None, occs=None, ctx_mask=None, eps=1e-6):
        """x ``(B, h, w, s)``; inters ``(B, k, h, w, s)``; flows/occs
        ``(B*k, ...)`` or None; ctx_mask ``(B, k)`` or None."""
        b, k = inters.shape[:2]
        h, w, s = x.shape[1:]
        inters_f = inters.reshape(b * k, *inters.shape[2:])
        flows, occs = self.matching(x, k, inters_f, flows, occs)
        flows, occs = self.subpixel(x, k, inters_f, flows, occs)
        warped = backwarp(inters_f, flows * self.flow_mult)

        confs = (1.0 - torch.sigmoid(occs.float())) + eps
        confs = confs.reshape(b, k, h, w, 1)
        if ctx_mask is not None:
            confs = confs * ctx_mask[:, :, None, None, None].float()
        denom = confs.sum(1).clamp_min(1e-20)
        warped_avg = (warped.reshape(b, k, h, w, s).float() * confs).sum(1) / denom
        occ_avg = (occs.reshape(b, k, h, w, 1).float() * confs).sum(1) / denom
        occ_mask = torch.sigmoid(occ_avg)
        fused = occ_mask * x.float() + (1.0 - occ_mask) * warped_avg
        if ctx_mask is not None:
            any_valid = (ctx_mask.sum(1) > 0)[:, None, None, None]
            fused = torch.where(any_valid, fused, x.float())
        return fused.to(x.dtype), flows, occs


def interblock_schedule(num_resolutions):
    """Per-resolution (kernel, flow_mult, corr_stride)."""
    return [{"kernel": 2 ** (i // 2 + 1) + 1, "flow_mult": float(2**i),
             "corr_stride": 2 if i > 2 else 1} for i in range(num_resolutions)]


class SkipDecoder(nn.Module):
    """SkipGAN decoder (RGB) with a context-fusion InterBlock per resolution."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        nres = cfg.num_resolutions
        chans, sizes = cfg.dec_channels, cfg.inter_sizes_dec
        sched = interblock_schedule(nres)
        self.add_module("block0", ConvLayerAE(cfg.z_size, chans[0], 1, dtype=dtype))
        for i in range(nres):
            if i > 0:
                self.add_module(f"block{i}", ResBlockAE(chans[i - 1], chans[i], upsample=True,
                                                        dtype=dtype))
            self.add_module(f"inter_block{i}", InterBlock(
                sched[i]["flow_mult"], sched[i]["kernel"], sizes[i], sched[i]["corr_stride"],
                first=(i == 0), dtype=dtype))
        self.add_module(f"block{nres}", ConvLayerAE(chans[-1], 3, 1, activate=False,
                                                    dtype=dtype))

    def forward(self, z, inters, ctx_mask=None):
        """Decode latents, warping in context features.

        Args:
          z: ``(B[, T], h, w, z_size)``.
          inters: per resolution in encoder order (finest first) the contexts
            ``(B*T, k, h_r, w_r, c_r)``.
          ctx_mask: optional ``(B*T, k)`` slot validity.

        Returns:
          ``(B[, T], H, W, 3)``.
        """
        cfg = self.cfg
        z, t = flatten_vid(z)
        nres = cfg.num_resolutions
        sizes = cfg.inter_sizes_dec
        out = self.block0(z)
        flows = occs = None
        for i in range(nres):
            if i > 0:
                out = getattr(self, f"block{i}")(out)
            head, tail = out[..., :sizes[i]], out[..., sizes[i]:]
            fused, flows, occs = getattr(self, f"inter_block{i}")(
                head, inters[nres - 1 - i], flows, occs, ctx_mask)
            out = torch.cat([fused, tail], dim=-1)
        return unflatten_vid(getattr(self, f"block{nres}")(out), t)
