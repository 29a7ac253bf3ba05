"""STFT audio autoencoder: spectrogram patches <-> audio tokens (counterpart
of ``ccvs_tpu/models/stft_model.py``), serving only (the reconstruction and
VQ losses come with the training slice).

Each frame's 64x16 spectrogram patch becomes an 8x2 latent of 16 channels and
so 16 tokens of a ``VectorQuantizer(stft_num, stft_size)``: the audio stream
that conditions the drums transformer. On CUDA that search is kernel K1, as
the frame autoencoder's is.
"""

import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.layers import EqualConv2d
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.nn.state import StftDecoder, StftEncoder


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
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, EqualConv2d):
                    m.weight.normal_(0.0, 1.0, generator=g)
                    if m.bias is not None:
                        m.bias.zero_()
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
