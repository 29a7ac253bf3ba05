"""SkipGAN decoder with the learnable optical-flow context module
(counterpart of ``ccvs_tpu/nn/decoder.py``), NHWC.

The ``k`` contexts are folded into the batch axis (b-major, k-minor); a
``ctx_mask (B, k)`` marks the valid context slots of a fixed-size FIFO. The
decoder features ``x`` are shared across the contexts, so every conv that
reads them computes their term once per batch element (exact by conv
linearity; ``shared_x_split``, the default; off, they convolve ``x`` tiled
over the contexts). Parameters are held in ``param_dtype`` and cast to the
compute ``dtype`` at use (``nn/layers.py``).
"""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import (ConvLayerAE, ResBlockAE, ToRGB, as_dtype, flatten_vid,
                                      unflatten_vid)
from ccvs_tpu_torch.ops.convops import conv_transpose2d
from ccvs_tpu_torch.ops.correlation import local_correlation
from ccvs_tpu_torch.ops.deform import deform_conv3x3
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
    """Cost-volume flow estimation, and the flow module's options of ``cfg``:
    a deformable conv at the flow (``use_deformed_conv``) in place of the
    warp, the warped context masked by the occlusion (``use_masked_flow``),
    Subpixel's features of the coarser resolution added to it
    (``use_tradeoff``), no cost volume (``no_corr``: a conv over ``[x,
    warped]``) or none of its 1x1 projection (``no_proj``)."""

    def __init__(self, cfg, flow_mult, kernel, feat_size, corr_stride, first,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.cfg, self.flow_mult, self.corr_stride = cfg, flow_mult, corr_stride
        if not first:
            self.upsample_flow = GroupedUpsample(2, **kw)
            self.upsample_occ = GroupedUpsample(1, **kw)
            if cfg.use_deformed_conv:
                pdt = param_dtype or dtype
                self.deform_weight = nn.Parameter(
                    torch.empty(feat_size, feat_size, 3, 3, dtype=pdt))
                self.deform_bias = nn.Parameter(torch.zeros(feat_size, dtype=pdt))
                self.deform_std = (2.0 / (feat_size * 9)) ** 0.5  # flax's draw, He normal
            if cfg.use_tradeoff:
                self.upsample_toff = GroupedUpsample(32, out_channels=feat_size, **kw)
        self.proj = None
        if cfg.no_corr:
            self.convs0 = ConvLayerAE(2 * feat_size, 128, 3, **kw)
        else:
            if feat_size > 16 and not cfg.no_proj:
                self.proj = ConvLayerAE(feat_size, max(16, feat_size // 4), 1, **kw)
            if corr_stride != 1:
                self.upsample_corr = GroupedUpsample(49, **kw)
            self.convs0 = ConvLayerAE(49, 128, 3, **kw)
        self.convs1 = ConvLayerAE(128, 64, 3, **kw)
        self.convs2 = ConvLayerAE(64, 32, 3, **kw)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, **kw)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, **kw)

    def forward(self, x, k, inter, flow, occ, toff=None):
        """x ``(B, h, w, s)`` shared decoder features; inter, flow, occ,
        toff ``(B*k, ...)``; flow and occ are None at the first block, toff
        is the coarser block's Subpixel features (``use_tradeoff``)."""
        cfg, s = self.cfg, self.corr_stride
        use_corr = not cfg.no_corr
        # with the cost volume on and the warped context read by it alone,
        # the correlation reads stride positions only: warp just those
        # (exact, the warp is per position)
        strided = (use_corr and s != 1 and not cfg.use_masked_flow and not cfg.use_tradeoff
                   and not cfg.use_deformed_conv)
        if flow is not None:
            flow = self.upsample_flow(flow)
            occ = self.upsample_occ(occ)
            if cfg.use_deformed_conv:
                inter = deform_conv3x3(inter, flow * self.flow_mult,
                                       as_dtype(self.deform_weight, inter.dtype),
                                       as_dtype(self.deform_bias, inter.dtype))
            elif not strided:
                inter = backwarp(inter, flow * self.flow_mult)
            if cfg.use_masked_flow:
                inter = inter * (1.0 - torch.sigmoid(occ))
            if cfg.use_tradeoff:
                inter = inter + self.upsample_toff(toff)
            if cfg.use_deformed_conv or cfg.use_tradeoff:
                inter = leaky_relu(inter, 0.1)
        if not use_corr:
            if cfg.shared_x_split:
                feat = self.convs0(inter, shared=x, k=k)
            else:
                feat = self.convs0(torch.cat([x.repeat_interleave(k, dim=0).to(inter.dtype),
                                              inter], dim=-1))
        else:
            if strided:
                xc = x[:, ::s, ::s]
                inter = (inter[:, ::s, ::s] if flow is None
                         else backwarp_sampled(inter, flow * self.flow_mult, s))
            else:
                xc = x
            if self.proj is None:
                px, pi = xc.repeat_interleave(k, dim=0), inter
            else:
                px = (self.proj(xc).repeat_interleave(k, dim=0) if cfg.shared_x_split
                      else self.proj(xc.repeat_interleave(k, dim=0)))
                pi = self.proj(inter)
            # on the stride grid, stride-s correlation is stride 1 on the samples
            corr = local_correlation(px.float(), pi.float(), stride=1 if strided else s)
            corr = leaky_relu(corr, 0.1).to(x.dtype)
            if s != 1:
                corr = self.upsample_corr(corr)
            feat = self.convs0(corr)
        feat = self.convs2(self.convs1(feat))
        dflow, docc = self.flow_head(feat), self.occ_head(feat)
        flow = dflow if flow is None else flow + dflow
        occ = docc if occ is None else occ + docc
        return flow, occ


class Subpixel(nn.Module):
    """Subpixel flow refinement; its last features are the next block's
    ``toff`` with ``use_tradeoff``."""

    def __init__(self, cfg, flow_mult, kernel, feat_size, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.cfg, self.flow_mult = cfg, flow_mult
        self.convs0 = ConvLayerAE(2 * feat_size + 3, 128, 3, **kw)
        self.convs1 = ConvLayerAE(128, 64, 3, **kw)
        self.convs2 = ConvLayerAE(64, 32, 3, **kw)
        self.flow_head = ConvLayerAE(32, 2, kernel, activate=False, **kw)
        self.occ_head = ConvLayerAE(32, 1, kernel, activate=False, **kw)

    def forward(self, x, k, inter, flow, occ):
        warped = backwarp(inter, flow * self.flow_mult)
        rest = torch.cat([warped, flow, occ], dim=-1)
        if self.cfg.shared_x_split:
            feat = self.convs0(rest, shared=x, k=k)
        else:
            feat = self.convs0(torch.cat([x.repeat_interleave(k, dim=0).to(rest.dtype), rest],
                                         dim=-1))
        feat = self.convs2(self.convs1(feat))
        toff = feat if self.cfg.use_tradeoff else None
        return flow + self.flow_head(feat), occ + self.occ_head(feat), toff


class InterBlock(nn.Module):
    """Per-resolution context fusion: flow by matching + subpixel refinement,
    then a confidence-weighted average of the warped contexts."""

    def __init__(self, cfg, flow_mult, kernel, feat_size, corr_stride, first=False,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        self.flow_mult = flow_mult
        self.matching = Matching(cfg, flow_mult, kernel, feat_size, corr_stride, first, dtype,
                                 param_dtype)
        self.subpixel = Subpixel(cfg, flow_mult, kernel, feat_size, dtype, param_dtype)

    def forward(self, x, inters, flows=None, occs=None, toffs=None, ctx_mask=None, eps=1e-6):
        """x ``(B, h, w, s)``; inters ``(B, k, h, w, s)``; flows, occs and
        toffs ``(B*k, ...)`` or None; ctx_mask ``(B, k)`` or None. Returns
        the fused features and the new flows, occs and toffs."""
        b, k = inters.shape[:2]
        h, w, s = x.shape[1:]
        inters_f = inters.reshape(b * k, *inters.shape[2:])
        flows, occs = self.matching(x, k, inters_f, flows, occs, toffs)
        flows, occs, toffs = self.subpixel(x, k, inters_f, flows, occs)
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
        return fused.to(x.dtype), flows, occs, toffs


def interblock_schedule(num_resolutions):
    """Per-resolution (kernel, flow_mult, corr_stride)."""
    return [{"kernel": 2 ** (i // 2 + 1) + 1, "flow_mult": float(2**i),
             "corr_stride": 2 if i > 2 else 1} for i in range(num_resolutions)]


class SkipDecoder(nn.Module):
    """SkipGAN decoder with a context-fusion InterBlock per resolution
    (none with ``cfg.use_inter`` off). ``mode``: ``"rgb"`` decodes frames;
    ``"layout"`` layout logits of ``cfg.layout_size`` classes (the separate
    layout twin); ``"both"`` decodes image and layout latents concatenated
    (``2 * z_size`` channels) into a frame (``rgb_head``) and layout logits
    (a refining conv, then ``layout_head``), the shared decoder of
    ``same_decoder_layout``. With ``cfg.skip_rgb`` a ``ToRGB`` head follows
    every resolution (``to_rgb{i}``), each adding the upsampled sum of the
    coarser ones, and in mode "rgb" their sum is the frame (``tanh`` of it
    with ``skip_tanh``)."""

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
            if cfg.use_inter:
                self.add_module(f"inter_block{i}", InterBlock(
                    cfg, sched[i]["flow_mult"], sched[i]["kernel"], sizes[i],
                    sched[i]["corr_stride"], first=(i == 0), **kw))
            if cfg.skip_rgb:
                self.add_module(f"to_rgb{i}", ToRGB(chans[i], **kw))
        if mode == "both":
            self.rgb_head = ConvLayerAE(chans[-1], 3, 1, activate=False, **kw)
            self.refine_layout = ConvLayerAE(chans[-1], chans[-1], 3, **kw)
            self.layout_head = ConvLayerAE(chans[-1], cfg.layout_size, 1, activate=False, **kw)
        elif mode == "layout" or not cfg.skip_rgb:
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
            ``(B*T, k, h_r, w_r, c_r)`` (:meth:`stack_contexts`); None,
            ``has_ctx=False`` or ``cfg.use_inter`` off decodes without
            context fusion.
          ctx_mask: optional ``(B*T, k)`` slot validity.
          return_all: also return the flows and occlusion logits of every
            resolution (``(B*T*k, h_r, w_r, 2 | 1)``, coarsest first) and the
            decoder's context-sized features (``(B[, T], h_r, w_r, c_r)``,
            coarsest first; before the fusion with ``inter_pre_warping``,
            after it without); empty lists without context fusion.
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
        use_inter = cfg.use_inter and inters is not None and has_ctx
        out = self.block0(z)
        flows = occs = toffs = skip = None
        inter_flows, inter_occs, inter_dec = [], [], []
        for i in range(nres):
            if i > 0:
                out = getattr(self, f"block{i}")(out)
            if use_inter:
                head, tail = out[..., :sizes[i]], out[..., sizes[i]:]
                if inter_pre_warping:
                    inter_dec.append(head)
                fused, flows, occs, toffs = getattr(self, f"inter_block{i}")(
                    head, inters[nres - 1 - i], flows, occs, toffs, ctx_mask)
                if keep_mask is not None:
                    fused = torch.where(keep_mask[:, None, None, None].bool(), fused, head)
                out = torch.cat([fused, tail], dim=-1)
                if not inter_pre_warping:
                    inter_dec.append(fused)
                inter_flows.append(flows)
                inter_occs.append(occs)
            if cfg.skip_rgb:
                skip = getattr(self, f"to_rgb{i}")(out, skip)
        layout = None
        if self.mode == "both":
            rgb = unflatten_vid(self.rgb_head(out), t)
            layout = unflatten_vid(self.layout_head(self.refine_layout(out)), t)
        else:
            if cfg.skip_rgb and self.mode == "rgb":
                rgb = skip
            else:
                rgb = getattr(self, f"block{nres}")(out)
            if cfg.skip_tanh and self.mode == "rgb":
                rgb = torch.tanh(rgb)
            rgb = unflatten_vid(rgb, t)
        if return_all:
            return rgb, layout, inter_flows, inter_occs, [unflatten_vid(f, t) for f in inter_dec]
        return rgb if layout is None else (rgb, layout)
