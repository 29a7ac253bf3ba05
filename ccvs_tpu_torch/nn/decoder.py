"""SkipGAN decoder with the learnable optical-flow context module
(counterpart of ``ccvs_tpu/nn/decoder.py``), NHWC.

The ``k`` contexts are folded into the batch axis (b-major, k-minor); a
``ctx_mask (B, k)`` marks the valid context slots of a fixed-size FIFO. The
decoder features ``x`` are shared across the contexts, so every conv that
reads them computes their term once per batch element (exact by conv
linearity; the JAX package's ``shared_x_split``, its default). Parameters
are held in ``param_dtype`` and cast to the compute ``dtype`` at use
(``nn/layers.py``).
"""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import (ConvLayerAE, ResBlockAE, as_dtype, flatten_vid,
                                      unflatten_vid)
from ccvs_tpu_torch.ops.convops import conv_transpose2d
from ccvs_tpu_torch.ops.correlation import local_correlation
from ccvs_tpu_torch.ops.fused_act import leaky_relu
from ccvs_tpu_torch.ops.warp import backwarp, backwarp_sampled


class GroupedUpsample(nn.Module):
    """Grouped 2x transposed conv (k=4, s=2, p=1, groups=C; weights drawn N(0, 0.02))."""

    init_std = 0.02

    def __init__(self, channels, out_channels=None, dtype=torch.float32, param_dtype=None):
        super().__init__()
        out_ch = out_channels or channels
        self.weight = nn.Parameter(torch.empty(channels, out_ch // channels, 4, 4,
                                               dtype=param_dtype or dtype))
        self.channels, self.dtype = channels, dtype

    def forward(self, x):
        return conv_transpose2d(x.to(self.dtype), as_dtype(self.weight, self.dtype), None,
                                stride=2, padding=1, groups=self.channels)


class Matching(nn.Module):
    """Cost-volume flow estimation."""

    def __init__(self, flow_mult, kernel, feat_size, corr_stride, first, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.flow_mult, self.corr_stride = flow_mult, corr_stride
        if not first:
            self.upsample_flow = GroupedUpsample(2, **kw)
            self.upsample_occ = GroupedUpsample(1, **kw)
        self.proj = (ConvLayerAE(feat_size, max(16, feat_size // 4), 1, **kw)
                     if feat_size > 16 else None)
        if corr_stride != 1:
            self.upsample_corr = GroupedUpsample(49, **kw)
        self.convs0 = ConvLayerAE(49, 128, 3, **kw)
        self.convs1 = ConvLayerAE(128, 64, 3, **kw)
        self.convs2 = ConvLayerAE(64, 32, 3, **kw)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, **kw)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, **kw)

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

    def __init__(self, flow_mult, kernel, feat_size, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.flow_mult = flow_mult
        self.convs0 = ConvLayerAE(2 * feat_size + 3, 128, 3, **kw)
        self.convs1 = ConvLayerAE(128, 64, 3, **kw)
        self.convs2 = ConvLayerAE(64, 32, 3, **kw)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, **kw)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, **kw)

    def forward(self, x, k, inter, flow, occ):
        warped = backwarp(inter, flow * self.flow_mult)
        rest = torch.cat([warped, flow, occ], dim=-1)
        feat = self.convs2(self.convs1(self.convs0(rest, shared=x, k=k)))
        return flow + self.flow_head(feat), occ + self.occ_head(feat)


class InterBlock(nn.Module):
    """Per-resolution context fusion: flow by matching + subpixel refinement,
    then a confidence-weighted average of the warped contexts."""

    def __init__(self, flow_mult, kernel, feat_size, corr_stride, first=False,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.flow_mult = flow_mult
        self.matching = Matching(flow_mult, kernel, feat_size, corr_stride, first, dtype,
                                 param_dtype)
        self.subpixel = Subpixel(flow_mult, kernel, feat_size, dtype, param_dtype)

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
    """SkipGAN decoder with a context-fusion InterBlock per resolution.
    ``mode``: ``"rgb"`` decodes frames; ``"layout"`` layout logits of
    ``cfg.layout_size`` classes (the separate layout twin); ``"both"``
    decodes image and layout latents concatenated (``2 * z_size``
    channels) into a frame (``rgb_head``) and layout logits (a refining
    conv, then ``layout_head``), the shared decoder of
    ``same_decoder_layout``."""

    def __init__(self, cfg, mode="rgb", dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.cfg, self.mode = cfg, mode
        nres = cfg.num_resolutions
        chans, sizes = cfg.dec_channels, cfg.inter_sizes_dec
        sched = interblock_schedule(nres)
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        in_size = cfg.z_size * 2 if mode == "both" else cfg.z_size
        self.add_module("block0", ConvLayerAE(in_size, chans[0], 1, **kw))
        for i in range(nres):
            if i > 0:
                self.add_module(f"block{i}", ResBlockAE(chans[i - 1], chans[i], upsample=True,
                                                        **kw))
            self.add_module(f"inter_block{i}", InterBlock(
                sched[i]["flow_mult"], sched[i]["kernel"], sizes[i], sched[i]["corr_stride"],
                first=(i == 0), **kw))
        if mode == "both":
            self.rgb_head = ConvLayerAE(chans[-1], 3, 1, activate=False, **kw)
            self.refine_layout = ConvLayerAE(chans[-1], chans[-1], 3, **kw)
            self.layout_head = ConvLayerAE(chans[-1], cfg.layout_size, 1, activate=False, **kw)
        else:
            out = cfg.layout_size if mode == "layout" else 3
            self.add_module(f"block{nres}", ConvLayerAE(chans[-1], out, 1, activate=False, **kw))

    @staticmethod
    def stack_contexts(inter_tgts):
        """A list of k contexts, each a list per resolution of ``(B[, T], h_r,
        w_r, c_r)`` features (the JAX package's ``inter_tgts``), as
        :meth:`forward` takes them: per resolution ``(B*T, k, h_r, w_r,
        c_r)``."""
        return [torch.stack([flatten_vid(ctx[r])[0] for ctx in inter_tgts], dim=1)
                for r in range(len(inter_tgts[0]))]

    @staticmethod
    def last_flow_mult(cfg):
        return float(2 ** (cfg.num_resolutions - 1))

    def forward(self, z, inters=None, ctx_mask=None, return_all=False, inter_pre_warping=True,
                has_ctx=True, keep_mask=None):
        """Decode latents, warping in context features.

        Args:
          z: ``(B[, T], h, w, z_size)``.
          inters: per resolution in encoder order (finest first) the contexts
            ``(B*T, k, h_r, w_r, c_r)`` (:meth:`stack_contexts`); None, or
            ``has_ctx=False``, decodes without context fusion.
          ctx_mask: optional ``(B*T, k)`` slot validity.
          return_all: also return the flows and occlusion logits of every
            resolution (``(B*T*k, h_r, w_r, 2 | 1)``, coarsest first) and the
            decoder's context-sized features (``(B[, T], h_r, w_r, c_r)``,
            coarsest first; before the fusion with ``inter_pre_warping``,
            after it without).
          keep_mask: optional ``(B*T,)`` 0/1: items with 0 skip the fusion.

        Returns:
          ``out`` ``(B[, T], H, W, 3 | layout_size)`` (``mode`` "rgb" or
          "layout"), or ``(rgb, layout)`` (``mode`` "both"); with
          ``return_all`` always the JAX package's ``(out, layout or None,
          flows, occs, inter_dec)``.
        """
        cfg = self.cfg
        z, t = flatten_vid(z)
        nres = cfg.num_resolutions
        sizes = cfg.inter_sizes_dec
        use_inter = inters is not None and has_ctx
        out = self.block0(z)
        flows = occs = None
        inter_flows, inter_occs, inter_dec = [], [], []
        for i in range(nres):
            if i > 0:
                out = getattr(self, f"block{i}")(out)
            if not use_inter:
                continue
            head, tail = out[..., :sizes[i]], out[..., sizes[i]:]
            if inter_pre_warping:
                inter_dec.append(head)
            fused, flows, occs = getattr(self, f"inter_block{i}")(
                head, inters[nres - 1 - i], flows, occs, ctx_mask)
            if keep_mask is not None:
                fused = torch.where(keep_mask[:, None, None, None].bool(), fused, head)
            out = torch.cat([fused, tail], dim=-1)
            if not inter_pre_warping:
                inter_dec.append(fused)
            inter_flows.append(flows)
            inter_occs.append(occs)
        layout = None
        if self.mode == "both":
            rgb = unflatten_vid(self.rgb_head(out), t)
            layout = unflatten_vid(self.layout_head(self.refine_layout(out)), t)
        else:
            rgb = unflatten_vid(getattr(self, f"block{nres}")(out), t)
        if return_all:
            return rgb, layout, inter_flows, inter_occs, [unflatten_vid(f, t) for f in inter_dec]
        return rgb if layout is None else (rgb, layout)
