"""Reconstruction metrics: PSNR, SSIM and LPIPS (counterpart of
``ccvs_tpu/eval/metrics.py``).

PSNR and SSIM are exact and computed in fp64. SSIM has scikit-image's
default semantics: a 7x7 uniform window, K1 0.01, K2 0.03, the sample
covariance (``cov_norm``), each channel's mean over the interior (the
border of 3 pixels left out), averaged over the channels. Since only the
interior counts, no window touches the border, so the windowed means are
``avg_pool2d(7, stride=1)`` without padding: the same function as the JAX
package's ``uniform_filter(mode="reflect")``, batched over frames on the
device.

LPIPS is the distance of unit-normalised VGG features
(:mod:`ccvs_tpu_torch.nn.vgg`): calibrated with the five ``lin`` channel
weights of an ``export_lpips`` npz (VGG16), uniform with a plain VGG npz,
and on seeded random VGG19 filters, with a warning, without one. Frames
below 161 px are first enlarged to at least 161 px by repeating pixels.
"""

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.nn import vgg as vgg_mod


def _f64(x, device="cpu"):
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.float64)


def psnr_frames(a, b, data_range: float = 1.0) -> torch.Tensor:
    """PSNR of each frame pair ``(N, ...)`` (fp64 tensors), ``inf`` where
    they are equal."""
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(dim=1)
    return 10 * torch.log10(data_range ** 2 / mse)


def ssim_frames(a, b, data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """Mean SSIM of each frame pair ``(N, H, W, C)`` (fp64 tensors)."""
    n, h, w, c = a.shape
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    nper = win_size ** 2
    cov_norm = nper / (nper - 1)
    x = a.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    y = b.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    ux, uy, uxx, uyy, uxy = F.avg_pool2d(torch.cat([x, y, x * x, y * y, x * y], dim=1),
                                         win_size, stride=1).unbind(1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2)).reshape(n, c).mean(dim=1)


def psnr(a, b, data_range: float = 1.0) -> float:
    """PSNR over images in [0, data_range]."""
    return float(psnr_frames(_f64(a)[None], _f64(b)[None], data_range)[0])


def ssim(a, b, data_range: float = 1.0, win_size: int = 7) -> float:
    """Mean SSIM of ``(H, W[, C])`` images in [0, data_range]."""
    a, b = _f64(a), _f64(b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    return float(ssim_frames(a[None], b[None], data_range, win_size)[0])


class LPIPS:
    """Perceptual distance over unit-normalised VGG features on ``device``
    (default: the GPU). With an ``export_lpips`` npz (VGG16 and the five
    ``lin`` channel weights) it is the calibrated LPIPS the reference scores
    with; a plain VGG npz gives uniform channel weights (uncalibrated); no
    npz falls back to random VGG19 filters of seed 0 with a warning. A path
    that is given but missing raises. Inputs in [-1, 1]."""

    def __init__(self, vgg_npz: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.lins = None
        if vgg_npz:
            if not os.path.exists(vgg_npz):
                raise FileNotFoundError(
                    f"vgg npz {vgg_npz!r} does not exist -- pass a real exported npz or omit "
                    "the flag to opt into the random-filter fallback")
            self.vgg, self.lins = vgg_mod.load_vgg_npz(vgg_npz, device=self.device)
        else:
            self.vgg = vgg_mod.make_vgg(None, seed=0, device=self.device, context="LPIPS")
        self.arch = self.vgg.arch
        self.calibrated = self.lins is not None

    @torch.no_grad()
    def distance(self, a, b) -> torch.Tensor:
        """``(N, H, W, 3)`` tensors on the device -> ``(N,)`` fp32."""
        if a.shape[1] < 161:
            s = int(math.ceil(161 / a.shape[1]))
            a = a.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
            b = b.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        total = 0.0
        for k, (x, y) in enumerate(zip(self.vgg.features(a), self.vgg.features(b))):
            xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-10)
            yn = y / (torch.linalg.vector_norm(y, dim=1, keepdim=True) + 1e-10)
            sq = (xn - yn) ** 2
            if self.lins is not None:  # a 1x1 conv's channel weights, then the spatial mean
                sq = sq * self.lins[k][None, :, None, None]
            total = total + sq.sum(dim=1).mean(dim=(1, 2))
        return total

    def __call__(self, a, b) -> np.ndarray:
        """``(N, H, W, 3)`` in [-1, 1] (numpy or tensors) -> ``(N,)``."""
        a, b = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
                for x in (a, b))
        return self.distance(a.to(self.device).float(), b.to(self.device).float()).cpu().numpy()


_lpips_cache = {}


def _get_lpips(vgg_npz=None, device=None):
    """One :class:`LPIPS` a weight file and device in a process: the scoring
    passes of ``eval-all`` share its VGG."""
    key = (vgg_npz, resolve_device(device))
    if key not in _lpips_cache:
        _lpips_cache[key] = LPIPS(vgg_npz, device=key[1])
    return _lpips_cache[key]


def lpips(a, b, vgg_npz=None, device=None):
    return _get_lpips(vgg_npz, device)(a, b)


@torch.no_grad()
def video_metrics(real_vids, fake_vids, per_timestep: Optional[int] = None, vgg_npz=None,
                  device=None) -> Dict[str, float]:
    """Mean PSNR, SSIM and LPIPS over ``(N, T, H, W, 3)`` videos in [0, 1],
    each clip on ``device`` (default: the GPU) at once: every frame, or
    frame ``per_timestep`` alone. The LPIPS key is ``lpips`` when
    calibrated and ``lpips_uncalibrated`` otherwise, with
    ``lpips_fallback_weights`` saying which."""
    lp = _get_lpips(vgg_npz, device)
    dev = lp.device
    n, t = real_vids.shape[:2]
    ts = [per_timestep] if per_timestep is not None else list(range(t))
    psnrs, ssims, lps = [], [], []
    for i in range(n):
        a = _f64(real_vids[i][ts], dev)
        b = _f64(fake_vids[i][ts], dev)
        psnrs.append(psnr_frames(a, b))
        ssims.append(ssim_frames(a, b))
        lps.append(lp.distance(a.float() * 2 - 1, b.float() * 2 - 1))
    lpips_key = "lpips" if lp.calibrated else "lpips_uncalibrated"
    return {
        "psnr": float(torch.cat(psnrs).mean()),
        "ssim": float(torch.cat(ssims).mean()),
        lpips_key: float(torch.cat(lps).double().mean()),
        # PSNR and SSIM are exact either way; only the perceptual key
        # degrades without calibrated weights
        "lpips_fallback_weights": not lp.calibrated,
    }
