"""State estimator (counterpart of ``StateEstimator`` in
``ccvs_tpu/nn/state.py``), NHWC: the STFT networks come with the audio slice."""

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
