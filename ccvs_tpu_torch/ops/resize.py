"""Bilinear resize of frames (counterpart of ``jax.image.resize(x, shape,
"bilinear")``, which the JAX package's ``down_size`` option calls).

``jax.image.resize`` antialiases when it shrinks: its triangle kernel widens
by the inverse scale, and at the borders the weights that fall inside the
image are renormalised. ``F.interpolate(mode="bilinear", antialias=True,
align_corners=False)`` computes the same weights (and, when it enlarges, the
plain half-pixel bilinear with the border sample repeated, which is what the
renormalised triangle gives there); ``tests/test_torch_serving.py`` holds the
two within 1e-5.
"""

import torch.nn.functional as F


def resize_bilinear(x, h_out, w_out):
    """Frames ``(..., H, W, C)`` -> ``(..., h_out, w_out, C)``, computed in
    fp32 and returned in ``x``'s dtype."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    flat = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    out = F.interpolate(flat, size=(h_out, w_out), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, h_out, w_out, c).to(x.dtype)


def resize_frames(x, size):
    """Frames ``(..., H, W, C)`` -> ``(..., size, size, C)``."""
    return resize_bilinear(x, size, size)
