"""Frame autoencoder: encode, quantize, and the doubly-autoregressive video
decode (counterpart of ``ccvs_tpu/models/autoencoder.py``).

The JAX package scans the rollout step as compiled programs; here it is a
Python loop over frames with the same fixed-shape per-resolution context
FIFO ``(B, M, h, w, c)`` and validity mask. Public tensors are NHWC.
"""

import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.decoder import SkipDecoder
from ccvs_tpu_torch.nn.encoder import SkipEncoder
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer


class FrameAutoencoder(nn.Module):
    """Encoder, quantizer and decoder, which compute in ``dtype`` and hold
    their parameters in ``param_dtype`` (default ``dtype``: serving's bf16
    parameters; the trainer holds fp32 ones under bf16 compute, as the JAX
    package does), except the codebook: it stays fp32, as vector
    quantization (kernel K1) is fp32, and the decoder casts the latents it
    looks up."""

    def __init__(self, cfg, dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        with resolve_device(device):
            self.encoder = SkipEncoder(cfg, dtype=dtype, param_dtype=param_dtype)
            self.quantizer = VectorQuantizer(cfg.z_num, cfg.z_size)
            self.decoder = SkipDecoder(cfg, dtype=dtype, param_dtype=param_dtype)

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
            self.quantizer.embedding.uniform_(-1.0 / n_e, 1.0 / n_e, generator=g)
        return self

    # ---------------- shapes ----------------

    def inter_shapes(self, batch):
        """Per-resolution context feature shapes, finest first."""
        h = self.cfg.max_dim
        return [(batch, h // 2**i, h // 2**i, c) for i, c in enumerate(self.cfg.inter_sizes_enc)]

    def _zero_inters(self, batch, slots):
        return [torch.zeros(s[0], slots, *s[1:], dtype=self.dtype, device=self.device)
                for s in self.inter_shapes(batch)]

    # ---------------- encode ----------------

    @torch.no_grad()
    def encode(self, frames):
        """Frames ``(B[, T], H, W, 3)`` in [-1, 1] -> dict of ``code``
        ``(B[, T], h*w)``, ``z`` (quantized latents, fp32) and ``inter`` (context
        features per resolution, finest first)."""
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

    # ---------------- single-frame decode ----------------

    def decode_frame(self, z, inter_fifo, fifo_mask, extra_ctx=None):
        """Decode one frame ``z`` ``(B, h, w, z_size)`` against the context
        FIFO (per resolution ``(B, M, h_r, w_r, c_r)``, slot ``M-1`` the most
        recent) with slot validity ``fifo_mask`` ``(B, M)``; returns the RGB
        frame ``(B, H, W, 3)``. ``extra_ctx`` (per resolution ``(B, h_r, w_r,
        c_r)``, the point-to-point end frame's features) is one more context
        slot after the FIFO's, always valid."""
        if extra_ctx is not None:
            inter_fifo = [torch.cat([f, e[:, None].to(f.dtype)], dim=1)
                          for f, e in zip(inter_fifo, extra_ctx)]
            fifo_mask = torch.cat([fifo_mask, fifo_mask.new_ones(fifo_mask.shape[0], 1)], dim=1)
        return self.decoder(z.to(self.dtype), inter_fifo, ctx_mask=fifo_mask)

    def refresh_inter(self, rgb):
        """Re-encode a decoded frame for fresh context features."""
        return self.encoder(rgb.to(self.dtype))[1]

    @staticmethod
    def fifo_push(inter_fifo, new_inter):
        """Shift the FIFO left and append ``new_inter`` at the last slot."""
        return [torch.cat([fifo[:, 1:], new[:, None].to(fifo.dtype)], dim=1)
                for fifo, new in zip(inter_fifo, new_inter)]

    def fifo_mask(self, batch, curr, slots=None):
        """``(B, slots)`` validity: slot ``s`` (dt = slots - s) is valid iff
        ``dt <= curr`` and dt is in ``skip_context``."""
        m = slots or self.cfg.skip_memory
        valid = [float(dt <= curr and dt in self.cfg.skip_context) for dt in range(m, 0, -1)]
        return torch.tensor(valid, device=self.device)[None].expand(batch, m)

    # ---------------- video decode (doubly-AR rollout) ----------------

    def _decode_step_fn(self, fifo, curr, z_t, kb=None, extra_ctx=None):
        """Decode frame ``z_t`` against the last ``kb`` FIFO slots (default,
        or 0: all of them) and ``extra_ctx``, then refresh the context and
        push it. Slots with ``dt > curr`` are invalid, so ``kb = min(curr,
        M)`` gives the result of the whole FIFO."""
        m = fifo[0].shape[1]
        kb = kb or m
        fifo_k = [f[:, m - kb:] for f in fifo] if kb < m else fifo
        rgb = self.decode_frame(z_t, fifo_k, self.fifo_mask(z_t.shape[0], curr, slots=kb),
                                extra_ctx)
        return self.fifo_push(fifo, self.refresh_inter(rgb)), rgb

    @torch.no_grad()
    def decode_video(self, codes, ctx_frames=None, n_ctx=1, cond_inter=None):
        """Decode tokens ``codes`` ``(B, T, h*w)`` autoregressively in image
        space: the ``n_ctx`` context frames against their own (encoded)
        context features, then each later frame against the FIFO of the
        re-encoded frames before it, and ``cond_inter`` (the end frame's
        context features in point-to-point mode), an extra slot at every
        step. With it, every frame decodes against all M FIFO slots, as the
        JAX package does. Returns ``(B, T, H, W, 3)``."""
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
