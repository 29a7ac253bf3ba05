"""State model: the estimator and a scalar codebook over the state's
coordinates (counterpart of ``ccvs_tpu/models/state_model.py``), with the
state trainer's loss.

The state tokens are the indices of a ``VectorQuantizer(state_num, 1)``: each
coordinate is its own depth-1 vector. On CUDA that search is kernel K1, which
pads the depth to 32 and masks codes past ``state_num``.
"""

import torch
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.nn.quantizer import VectorQuantizer
from ccvs_tpu_torch.nn.state import StateEstimator


class StateModel(nn.Module):
    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        with resolve_device(device):
            self.estimator = StateEstimator(cfg, dtype=dtype)
            self.quantizer = VectorQuantizer(cfg.state_num, 1)

    @property
    def device(self):
        return self.quantizer.embedding.device

    def init(self, seed=0):
        """Seeded random parameters (flax's initializers: conv and linear
        weights N(0, 1), biases 0, the scalar codebook U(0, 1)). Returns self."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        init_equalized(self, g)
        with torch.no_grad():
            self.quantizer.embedding.uniform_(0.0, 1.0, generator=g)
        return self

    @torch.no_grad()
    def estimate(self, z):
        """Latents ``(B[, T], h, w, z_size)`` -> states ``(B[, T], state_size)``
        in [0, 1]."""
        return self.estimator(z)

    @torch.no_grad()
    def encode(self, z=None, state=None):
        """Latents (or states) -> state tokens ``(B, T * state_size)``, one
        token per coordinate."""
        if state is None:
            state = self.estimate(z)
        _, idx = self.quantizer.quantize(state.float()[..., None])
        return idx.reshape(idx.shape[0], -1)

    def loss(self, z, state_target):
        """Regression MSE of the estimate plus the scalar quantizer's VQ loss
        on the (detached) target states (``state_model.py:78-107``); returns
        ``(loss, {"state_reg", "state_quant", "state_perp"})``. The
        quantizer's search is K1 on CUDA; the codebook's gradient comes
        through its gather."""
        pred = self.estimator(z)
        reg = ((pred - state_target) ** 2).mean()
        _, qloss, (perp, _) = self.quantizer(state_target.detach()[..., None])
        return reg + qloss, {"state_reg": reg, "state_quant": qloss, "state_perp": perp}

    def decode(self, state_code):
        """State tokens -> state values of the same shape."""
        return self.quantizer.embed_code(state_code)[..., 0]
