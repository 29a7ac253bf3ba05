"""STFT audio autoencoder: spectrogram patches <-> audio tokens, and its
training loss (counterpart of ``ccvs_tpu/models/stft_model.py``).

Each frame's 64x16 spectrogram patch becomes an 8x2 latent of 16 channels and
so 16 tokens of a ``VectorQuantizer(stft_num, stft_size)``: the audio stream
that conditions the drums transformer. On CUDA that search is kernel K1, as
the frame autoencoder's is.
"""

import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.nn.state import StftDecoder, StftEncoder
from ccvs_tpu_torch.nn.vgg import vgg_loss


class StftModel(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.encoder = StftEncoder(cfg, dtype=dtype)
            self.quantizer = VectorQuantizer(cfg.stft_num, cfg.stft_size)
            self.decoder = StftDecoder(cfg, dtype=dtype)

    @property
    def device(self):
        return self.quantizer.embedding.device

    def init(self, seed=0):
        """Seeded random parameters (flax's initializers: conv weights N(0, 1),
        biases 0, the codebook U(-1/n, 1/n)). Returns self."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        n = self.cfg.stft_num
        init_equalized(self, g)
        with torch.no_grad():
            self.quantizer.embedding.uniform_(-1.0 / n, 1.0 / n, generator=g)
        return self

    @torch.no_grad()
    def encode(self, stft):
        """Spectrogram patches ``(B[, T], 64, 16, 1)`` -> audio tokens
        ``(B, T * 16)`` (nearest codes of the latents, K1 on CUDA)."""
        _, idx = self.quantizer.quantize(self.encoder(stft).float())
        return idx.reshape(idx.shape[0], -1)

    @torch.no_grad()
    def decode(self, code):
        """Audio tokens ``(B, T * 16)`` -> spectrogram patches
        ``(B, T, 64, 16, 1)``."""
        idx = code.reshape(code.shape[0], -1, *self.cfg.stft_shape)
        return self.decoder(self.quantizer.embed_code(idx))

    def loss(self, stft, vgg=None):
        """``(loss, metrics)`` of spectrogram patches ``(N, 64, 16, 1)``: the
        reconstruction's MSE, the VQ loss and, with ``vgg``, the perceptual
        loss of the patches as 3-channel images (``stft_model.py:84-110``).
        K1 once on CUDA."""
        lat_q, qloss, (perp, _) = self.quantizer(self.encoder(stft))
        rec = self.decoder(lat_q)
        mse = ((rec - stft) ** 2).mean()
        loss = mse + qloss
        metrics = {"stft_mse": mse, "stft_quant": qloss, "stft_perp": perp}
        if vgg is not None:
            v = vgg_loss(vgg, rec.expand(*rec.shape[:-1], 3), stft.expand(*stft.shape[:-1], 3))
            loss = loss + v
            metrics["stft_vgg"] = v
        return loss, metrics
