"""State estimator and STFT audio autoencoder networks (counterparts of
``StateEstimator``, ``StftEncoder`` and ``StftDecoder`` in
``ccvs_tpu/nn/state.py``), NHWC."""

import torch
from torch import nn

from ccvs_tpu_torch.nn.layers import ConvLayerAE, EqualLinear, flatten_vid, unflatten_vid


class StateEstimator(nn.Module):
    """A state vector (the arm's (x, y) on BAIR) in [0, 1]^d from the latent
    grid: stride-2 convs down to 1x1 (``conv<i>``), a linear layer (``fc``),
    a sigmoid."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        h, w = cfg.z_shape
        in_size, i = cfg.z_size, 0
        while h > 1 and w > 1:
            self.add_module(f"conv{i}", ConvLayerAE(in_size, cfg.state_hsize, 3, downsample=True,
                                                    dtype=dtype))
            h, w, in_size, i = h // 2, w // 2, cfg.state_hsize, i + 1
        self.n_conv = i
        self.fc = EqualLinear(cfg.state_hsize * h * w, cfg.state_size, dtype=dtype)

    def forward(self, z):
        """z ``(B[, T], h, w, z_size)`` -> ``(B[, T], state_size)``."""
        out, t = flatten_vid(z)
        for i in range(self.n_conv):
            out = getattr(self, f"conv{i}")(out)
        # channel-major flattening, as the JAX package's NCHW transpose
        out = out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
        return unflatten_vid(torch.sigmoid(self.fc(out)), t)


class StftEncoder(nn.Module):
    """A 64x16 spectrogram patch (1 channel) -> an 8x2 latent of
    ``stft_size`` channels: a 1x1 conv (``conv0``), three stride-2 convs
    (``conv1``-``conv3``), a 3x3 conv (``conv4``), each with its LeakyReLU."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        hs = cfg.stft_hsize
        self.conv0 = ConvLayerAE(1, hs, 1, dtype=dtype)
        for i in range(1, 4):
            self.add_module(f"conv{i}", ConvLayerAE(hs, hs, 3, downsample=True, dtype=dtype))
        self.conv4 = ConvLayerAE(hs, cfg.stft_size, 3, dtype=dtype)

    def forward(self, x):
        """``(B[, T], 64, 16, 1)`` -> ``(B[, T], 8, 2, stft_size)``."""
        out, t = flatten_vid(x)
        for i in range(5):
            out = getattr(self, f"conv{i}")(out)
        return unflatten_vid(out, t)


class StftDecoder(nn.Module):
    """An 8x2 latent -> a 64x16 spectrogram patch: a 3x3 conv (``conv0``),
    three stride-2 transposed convs (``conv1``-``conv3``), a 1x1 conv to one
    channel (``conv4``), then ``tanh``."""

    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        hs = cfg.stft_hsize
        self.conv0 = ConvLayerAE(cfg.stft_size, hs, 3, dtype=dtype)
        for i in range(1, 4):
            self.add_module(f"conv{i}", ConvLayerAE(hs, hs, 3, upsample=True, dtype=dtype))
        self.conv4 = ConvLayerAE(hs, 1, 1, dtype=dtype)

    def forward(self, z):
        """``(B[, T], 8, 2, stft_size)`` -> ``(B[, T], 64, 16, 1)`` in [-1, 1]."""
        out, t = flatten_vid(z)
        for i in range(5):
            out = getattr(self, f"conv{i}")(out)
        return unflatten_vid(torch.tanh(out), t)
