"""Latent-transformer training (counterpart of
``ccvs_tpu/train/transformer_trainer.py``). So far only :func:`blur_video`,
which the deblurring mode of serving shares with it; the trainer comes with
the training slice.
"""

import torch
import torch.nn.functional as F


def _reflect_index(n, radius, device):
    """Source indices of a length-``n`` axis padded by ``radius`` on both
    sides in scipy's ``"reflect"`` mode (``d c b a | a b c d | d c b a``, the
    edge sample repeated; torch's ``"reflect"`` padding is scipy's
    ``"mirror"``), for any ``radius``: the padded axis repeats with period
    ``2 n``."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def blur_video(vid, sigma):
    """Gaussian blur of each frame and channel of ``vid`` ``(B, T, H, W, C)``
    on its device: ``scipy.ndimage.gaussian_filter(frame, sigma,
    truncate=1.5)`` in mode ``"reflect"``, as the JAX package computes it on
    the host. Two separable 1-D convolutions of radius ``int(1.5 * sigma +
    0.5)``, in fp32; returns ``vid``'s dtype."""
    b, t, h, w, c = vid.shape
    radius = int(1.5 * sigma + 0.5)
    dev = vid.device
    x = torch.arange(-radius, radius + 1, dtype=torch.float64, device=dev)
    k = torch.exp(-0.5 / (sigma * sigma) * x * x)
    k = (k / k.sum()).float()
    frames = vid.permute(0, 1, 4, 2, 3).reshape(-1, 1, h, w).float()
    frames = frames.index_select(2, _reflect_index(h, radius, dev))
    frames = F.conv2d(frames, k.view(1, 1, -1, 1))
    frames = frames.index_select(3, _reflect_index(w, radius, dev))
    frames = F.conv2d(frames, k.view(1, 1, 1, -1))
    return frames.reshape(b, t, c, h, w).permute(0, 1, 3, 4, 2).to(vid.dtype)
