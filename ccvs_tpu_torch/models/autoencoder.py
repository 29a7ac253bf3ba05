"""Frame autoencoder: encode, quantize, and the doubly-autoregressive video
decode (counterpart of ``ccvs_tpu/models/autoencoder.py``), with the layout
twins: an encoder and quantizer over one-hot segmentation maps and their
decode, alone or through the image decoder (``same_decoder_layout``).

The JAX package scans the rollout step as compiled programs; here it is a
Python loop over frames with the same fixed-shape per-resolution context
FIFO ``(B, M, h, w, c)`` and validity mask. Public tensors are NHWC.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.decoder import SkipDecoder
from ccvs_tpu_torch.nn.encoder import SkipEncoder
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.utils import profiling


class FrameAutoencoder(nn.Module):
    """Encoder, quantizer and decoder, which compute in ``dtype`` and hold
    their parameters in ``param_dtype`` (default ``dtype``: serving's bf16
    parameters; the trainer holds fp32 ones under bf16 compute, as the JAX
    package does), except the codebook: it stays fp32, as vector
    quantization (kernel K1) is fp32, and the decoder casts the latents it
    looks up.

    With ``cfg.use_layout`` it has the layout twins (``quantized_video_model
    .py:132-160``): ``encoder_l`` and ``quantizer_l`` over one-hot layouts of
    ``cfg.layout_size`` classes, and either ``decoder_l`` (their own
    decoder) or, with ``same_decoder_layout``, the image decoder in mode
    "both", which decodes image and layout latents together into a frame
    and layout logits."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        shared = cfg.use_layout and cfg.same_decoder_layout
        self.encoder_l = self.quantizer_l = self.decoder_l = None
        with resolve_device(device):
            self.encoder = SkipEncoder(cfg, **kw)
            self.quantizer = self._quantizer()
            self.decoder = SkipDecoder(cfg, mode="both" if shared else "rgb", **kw)
            if cfg.use_layout:
                self.encoder_l = SkipEncoder(cfg, mode="layout", **kw)
                self.quantizer_l = self._quantizer()
                if not shared:
                    self.decoder_l = SkipDecoder(cfg, mode="layout", **kw)

    def _quantizer(self):
        """A codebook of ``z_num`` codes of ``z_size // z_mult`` channels,
        its lookups normalized with ``normalize_out``."""
        cfg = self.cfg
        return VectorQuantizer(cfg.z_num, cfg.z_size, mult=cfg.z_mult, normalize=cfg.normalize_out)

    @property
    def device(self):
        return self.quantizer.embedding.device

    def init(self, seed=0):
        """Seeded random parameters (flax's initializers: conv weights N(0, 1),
        grouped upsamplers N(0, 0.02), codebook U(-1/n_e, 1/n_e)). Returns self."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        init_equalized(self, g)
        with torch.no_grad():
            n_e = self.cfg.z_num
            for q in (self.quantizer, self.quantizer_l):
                if q is not None:
                    q.embedding.uniform_(-1.0 / n_e, 1.0 / n_e, generator=g)
        return self

    # ---------------- shapes ----------------

    def inter_shapes(self, batch):
        """Per-resolution context feature shapes, finest first, of frames of
        ``max_dim x int(max_dim * aspect_ratio)``."""
        cfg = self.cfg
        h, w = cfg.max_dim, int(cfg.max_dim * cfg.aspect_ratio)
        return [(batch, h // 2**i, w // 2**i, c) for i, c in enumerate(cfg.inter_sizes_enc)]

    def _zero_inters(self, batch, slots):
        return [torch.zeros(s[0], slots, *s[1:], dtype=self.dtype, device=self.device)
                for s in self.inter_shapes(batch)]

    # ---------------- encode ----------------

    @torch.no_grad()
    def encode(self, frames):
        """Frames ``(B[, T], H, W, 3)`` in [-1, 1] -> dict of ``code``
        ``(B[, T], h*w)``, ``z`` (quantized latents, fp32) and ``inter`` (context
        features per resolution, finest first). With ``z_mult`` > 1 the
        indices have the JAX package's shape, ``(B[, T], h, w * z_mult)``;
        :meth:`embed_code` cannot take such a code back, in either package."""
        z, inters = self.encoder(frames.to(self.dtype))
        z_q, idx = self.quantizer.quantize(z.float())
        lead = idx.shape[:idx.ndim - 2]
        return {"code": idx.reshape(*lead, -1), "z": z_q, "inter": inters}

    @torch.no_grad()
    def reconstruct(self, frames):
        """Per-frame reconstruction: encode, quantize, decode each frame
        against its own context features (the reference's ``rec/`` output,
        the trainer's held-out eval). ``(B[, T], H, W, 3)`` in the compute
        dtype."""
        enc = self.encode(frames)
        return self.decoder(enc["z"].to(self.dtype), SkipDecoder.stack_contexts([enc["inter"]]))

    def embed_code(self, code):
        """Token indices ``(B[, T], h*w)`` -> latents ``(B[, T], h, w, z_size)``."""
        return self.quantizer.embed_code(code.reshape(*code.shape[:-1], *self.cfg.z_shape))

    # ---------------- layouts ----------------

    def one_hot_layout(self, layout):
        """Integer segmentations ``(B[, T], H, W)`` -> one-hot ``(..., layout_size)``
        fp32 (``quantized_video_model.py:259,491``)."""
        return F.one_hot(layout.long(), self.cfg.layout_size).float()

    @torch.no_grad()
    def encode_layout(self, layout):
        """Layouts ``(B[, T], H, W)`` -> dict of ``code`` ``(B[, T], h*w)``
        (the layout codebook's indices: one K1 launch on CUDA), ``z`` (the
        quantized layout latents) and ``inter`` (the layout encoder's context
        features per resolution, finest first)."""
        zl, inters = self.encoder_l(self.one_hot_layout(layout).to(self.dtype))
        zl_q, idx = self.quantizer_l.quantize(zl.float())
        lead = idx.shape[:idx.ndim - 2]
        return {"code": idx.reshape(*lead, -1), "z": zl_q, "inter": inters}

    @staticmethod
    def merge_layout_inters(inter, inter_l):
        """Per resolution the first half of the image features' channels and
        the second half of the layout features' (``quantized_video_model.py:
        330-334``)."""
        out = []
        for f, fl in zip(inter, inter_l):
            half = f.shape[-1] // 2
            out.append(torch.cat([f[..., :half], fl[..., half:].to(f.dtype)], dim=-1))
        return out

    def embed_layout_code(self, code):
        """Layout token indices ``(B[, T], h*w)`` -> layout latents through
        the layout codebook (``quantized_video_model.py:840-842``)."""
        return self.quantizer_l.embed_code(code.reshape(*code.shape[:-1], *self.cfg.z_shape))

    # ---------------- single-frame decode ----------------

    def decode_frame(self, z, inter_fifo, fifo_mask, extra_ctx=None, with_inter=False):
        """Decode one frame ``z`` ``(B, h, w, z_size)`` against the context
        FIFO (per resolution ``(B, M, h_r, w_r, c_r)``, slot ``M-1`` the most
        recent) with slot validity ``fifo_mask`` ``(B, M)``; returns the RGB
        frame ``(B, H, W, 3)``, and with ``with_inter`` also the decoder's
        fused context-sized features per resolution, finest first (the new
        context of ``skip_mode`` "dec"). ``extra_ctx`` (per resolution ``(B,
        h_r, w_r, c_r)``, the point-to-point end frame's features) is one
        more context slot after the FIFO's, always valid."""
        if extra_ctx is not None:
            inter_fifo = [torch.cat([f, e[:, None].to(f.dtype)], dim=1)
                          for f, e in zip(inter_fifo, extra_ctx)]
            fifo_mask = torch.cat([fifo_mask, fifo_mask.new_ones(fifo_mask.shape[0], 1)], dim=1)
        if not with_inter:
            return self.decoder(z.to(self.dtype), inter_fifo, ctx_mask=fifo_mask)
        rgb, _, _, _, inter_dec = self.decoder(z.to(self.dtype), inter_fifo, ctx_mask=fifo_mask,
                                               return_all=True, inter_pre_warping=False)
        return rgb, inter_dec[::-1]

    def refresh_inter(self, rgb):
        """Re-encode a decoded frame for fresh context features."""
        return self.encoder(rgb.to(self.dtype))[1]

    @staticmethod
    def fifo_push(inter_fifo, new_inter, curr=0, keep_first=False, n_first=1):
        """Shift the FIFO left and append ``new_inter`` at the last slot; with
        ``keep_first``, once ``curr`` (the frames decoded so far) fills the
        FIFO, its first ``n_first`` slots stay and the slot after them goes
        (``quantized_video_model.py:895-902``)."""
        out = []
        for fifo, new in zip(inter_fifo, new_inter):
            keep = fifo[:, :n_first] if keep_first and curr >= fifo.shape[1] else fifo[:, :0]
            out.append(torch.cat([keep, fifo[:, keep.shape[1] + 1:], new[:, None].to(fifo.dtype)],
                                 dim=1))
        return out

    def fifo_mask(self, batch, curr, slots=None):
        """``(B, slots)`` validity: slot ``s`` (dt = slots - s) is valid iff
        ``dt <= curr`` and dt is in ``skip_context``."""
        m = slots or self.cfg.skip_memory
        valid = [float(dt <= curr and dt in self.cfg.skip_context) for dt in range(m, 0, -1)]
        return torch.tensor(valid, device=self.device)[None].expand(batch, m)

    # ---------------- video decode (doubly-AR rollout) ----------------

    def _decode_step_fn(self, fifo, curr, z_t, kb=None, extra_ctx=None):
        """Decode frame ``z_t`` against the last ``kb`` FIFO slots (default,
        or 0: all of them) and ``extra_ctx``, then push the new context: the
        re-encoded frame, or with ``skip_mode`` "dec" the decoder's fused
        features. Slots with ``dt > curr`` are invalid, so ``kb = min(curr,
        M)`` gives the result of the whole FIFO (the JAX package's
        ``decode_buckets`` round ``kb`` up; the masked slots weigh 0)."""
        cfg = self.cfg
        m = fifo[0].shape[1]
        kb = kb or m
        fifo_k = [f[:, m - kb:] for f in fifo] if kb < m else fifo
        mask = self.fifo_mask(z_t.shape[0], curr, slots=kb)
        if cfg.skip_mode == "enc":
            rgb = self.decode_frame(z_t, fifo_k, mask, extra_ctx)
            new_inter = self.refresh_inter(rgb)
        else:
            rgb, new_inter = self.decode_frame(z_t, fifo_k, mask, extra_ctx, with_inter=True)
        return self.fifo_push(fifo, new_inter, curr, cfg.keep_first, cfg.n_first), rgb

    @torch.no_grad()
    @profiling.spanned("decode")
    def decode_video(self, codes, ctx_frames=None, n_ctx=1, cond_inter=None):
        """Decode tokens ``codes`` ``(B, T, h*w)`` autoregressively in image
        space: the ``n_ctx`` context frames against their own (encoded)
        context features, then each later frame against the FIFO of the
        re-encoded frames before it (their decoder features with
        ``skip_mode`` "dec"; the first ``n_first`` pinned with
        ``keep_first``), and ``cond_inter`` (the end frame's context
        features in point-to-point mode), an extra slot at every step. With
        it, every frame decodes against all M FIFO slots, as the JAX package
        does. Returns ``(B, T, H, W, 3)``."""
        cfg = self.cfg
        b, t = codes.shape[:2]
        m = cfg.skip_memory
        z_all = self.embed_code(codes)
        fifo = self._zero_inters(b, m)
        ctx_rgb = None
        if n_ctx > 0:
            ctx_inters = self.encode(ctx_frames)["inter"]  # (B, n_ctx, ...) each
            ctx_rgb = self.decoder(
                z_all[:, :n_ctx].to(self.dtype),
                [f.reshape(b * n_ctx, 1, *f.shape[2:]) for f in ctx_inters])
            take = min(n_ctx, m)
            for r in range(len(fifo)):
                fifo[r][:, m - take:] = ctx_inters[r][:, n_ctx - take:n_ctx].to(self.dtype)
        frames = [] if ctx_rgb is None else [ctx_rgb]
        for curr in range(n_ctx, t):
            if cond_inter is None:
                fifo, rgb = self._decode_step_fn(fifo, curr, z_all[:, curr], kb=min(curr, m))
            else:
                fifo, rgb = self._decode_step_fn(fifo, curr, z_all[:, curr], extra_ctx=cond_inter)
            frames.append(rgb[:, None])
        return torch.cat(frames, dim=1)

    @torch.no_grad()
    @profiling.spanned("decode")
    def decode_video_layout(self, codes, layout_codes, ctx_frames, ctx_layout, n_ctx=1,
                            interl_gen=None):
        """The layout-conditioned doubly-AR rollout of the shared decoder
        (``same_decoder_layout``; the ``use_layout`` branch of
        ``QVidModel.decode``, ``quantized_video_model.py:836-903``): each
        frame decodes its image and layout latents together against a FIFO
        of context features that are half image, half layout channels
        (:meth:`merge_layout_inters`); each decoded frame is re-encoded, its
        layout either given (``interl_gen``) or re-encoded from the argmax of
        its own layout logits.

        Args:
          codes, layout_codes: ``(B, T, h*w)`` frame and layout tokens, the
            context frames' included.
          ctx_frames: ``(B, n_ctx, H, W, 3)`` real context frames;
            ``ctx_layout`` ``(B, n_ctx, H, W)`` their layouts.
          interl_gen: optional, per resolution ``(B, T - n_ctx, h_r, w_r,
            c_r)``: the given layouts' encoder features of the frames after
            the context.

        Returns:
          ``(vid, layout_logits)``: ``(B, T, H, W, 3)`` and ``(B, T, H, W,
          layout_size)`` in the compute dtype.
        """
        cfg = self.cfg
        if not (cfg.use_layout and cfg.same_decoder_layout):
            raise ValueError("the layout rollout needs the shared-decoder layout twins "
                             "(use_layout and same_decoder_layout)")
        b, t = codes.shape[:2]
        m = cfg.skip_memory
        z = torch.cat([self.embed_code(codes), self.embed_layout_code(layout_codes)], dim=-1)
        merged = self.merge_layout_inters(self.encode(ctx_frames)["inter"],
                                          self.encode_layout(ctx_layout)["inter"])
        ctx_rgb, ctx_lay = self.decoder(
            z[:, :n_ctx].to(self.dtype),
            [f.reshape(b * n_ctx, 1, *f.shape[2:]) for f in merged])
        fifo = self._zero_inters(b, m)
        take = min(n_ctx, m)
        for r in range(len(fifo)):
            fifo[r][:, m - take:] = merged[r][:, n_ctx - take:n_ctx].to(self.dtype)
        frames, lays = [ctx_rgb], [ctx_lay]
        for curr in range(n_ctx, t):
            kb = min(curr, m)
            rgb, lay = self.decoder(z[:, curr].to(self.dtype), [f[:, m - kb:] for f in fifo],
                                    ctx_mask=self.fifo_mask(b, curr, slots=kb))
            if interl_gen is None:
                seg = lay.float().argmax(-1)
                new_interl = self.encoder_l(self.one_hot_layout(seg).to(self.dtype))[1]
            else:
                new_interl = [f[:, curr - n_ctx] for f in interl_gen]
            new_inter = self.merge_layout_inters(self.refresh_inter(rgb), new_interl)
            fifo = self.fifo_push(fifo, new_inter, curr, cfg.keep_first, cfg.n_first)
            frames.append(rgb[:, None])
            lays.append(lay[:, None])
        return torch.cat(frames, dim=1), torch.cat(lays, dim=1)
