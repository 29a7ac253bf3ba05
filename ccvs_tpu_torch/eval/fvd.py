"""Fréchet Video Distance (counterpart of ``ccvs_tpu/eval/fvd.py``).

The Fréchet distance is exact (numpy and ``scipy.linalg.sqrtm`` on the
host, as in the JAX package). The video embedder is pluggable:

- :class:`I3D`, the Inflated Inception-v1 backbone at full width (1024-d
  embeddings), from the ``variables`` npz of
  ``python -m ccvs_tpu_torch.port.export_i3d`` or, without one, seeded random filters;
- :func:`make_fallback_embedder`, a fixed random 3D-conv network: its FVD is
  self-consistent (it tracks relative progress) but not comparable to
  published I3D-FVD numbers.

The embedders compute in fp32 on their device (the CUDA device unless the
caller asks for another, through :func:`~ccvs_tpu_torch.device.resolve_device`,
which also keeps fp32 convolutions out of TF32). Layout inside is NCTHW.

TF's ``"SAME"`` padding is asymmetric and depends on the input's size: per
dimension ``total = max((ceil(n / s) - 1) * s + k - n, 0)``, ``total // 2``
before and the rest after (the stem's stride-2 7x7x7 conv pads (2, 3) on
even sizes). ``F.conv3d`` and ``F.max_pool3d`` pad symmetrically, so every
convolution and pool here pads explicitly first (max-pools with ``-inf``).

Protocol: 16-frame clips in [-1, 1] resized to 224x224 on the device
(antialiased bilinear, as ``jax.image.resize``), batch 16; mean and std over
chunks of ``chunk`` videos when asked.
"""

import math
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.ops.resize import resize_bilinear


def frechet_distance(act1: np.ndarray, act2: np.ndarray, eps: float = 1e-6) -> float:
    """Fréchet distance between two sets of activations ``(N, D)``."""
    from scipy import linalg

    mu1, mu2 = act1.mean(0), act2.mean(0)
    s1 = np.cov(act1, rowvar=False)
    s2 = np.cov(act2, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1.dot(s2))
    if isinstance(covmean, tuple):  # older scipy returned (sqrtm, errest)
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset).dot(s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def same_pad(x, kernel, stride, value=0.0):
    """``x`` ``(N, C, *spatial)`` padded as TF's ``"SAME"`` pads it for a
    window ``kernel`` at ``stride``."""
    pads = []
    for n, k, s in zip(x.shape[2:], kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    if not any(lo or hi for lo, hi in pads):
        return x
    return F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi], value=value)


def max_pool_same(x, kernel, stride):
    return F.max_pool3d(same_pad(x, kernel, stride, value=-math.inf), kernel, stride)


class _Conv(nn.Module):
    """A conv's parameters under flax's names: ``weight (O, I, *kernel)``
    (from flax's ``kernel``) and ``bias`` when it has one."""

    def __init__(self, cin, cout, kernel, bias):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False) if bias else None


class FrozenBatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-3)``: the running
    statistics, never updated."""

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class Unit3D(nn.Module):
    """A "SAME" 3D convolution, batch norm (no conv bias) and ReLU."""

    def __init__(self, cin, cout, kernel=(1, 1, 1), stride=(1, 1, 1), use_bn=True,
                 activation=True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = _Conv(cin, cout, self.kernel, bias=not use_bn)
        self.bn = FrozenBatchNorm(cout) if use_bn else None

    def forward(self, x):
        x = F.conv3d(same_pad(x, self.kernel, self.stride), self.conv3d.weight,
                     self.conv3d.bias, self.stride)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """Four branches: 1x1; 1x1 then 3x3x3; 1x1 then 3x3x3; a 3x3x3 max-pool
    then 1x1. ``ch`` is ``(b0, b1a, b1b, b2a, b2b, b3b)``."""

    def __init__(self, cin, ch):
        super().__init__()
        self.out_channels = ch[0] + ch[2] + ch[4] + ch[5]
        self.Branch_0 = Unit3D(cin, ch[0])
        self.Branch_1a = Unit3D(cin, ch[1])
        self.Branch_1b = Unit3D(ch[1], ch[2], (3, 3, 3))
        self.Branch_2a = Unit3D(cin, ch[3])
        self.Branch_2b = Unit3D(ch[3], ch[4], (3, 3, 3))
        self.Branch_3b = Unit3D(cin, ch[5])

    def forward(self, x):
        b0 = self.Branch_0(x)
        b1 = self.Branch_1b(self.Branch_1a(x))
        b2 = self.Branch_2b(self.Branch_2a(x))
        b3 = self.Branch_3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


class I3D(nn.Module):
    """Inflated Inception-v1 video backbone: ``(B, T, H, W, 3)`` in [-1, 1]
    -> ``(B, 1024)``."""

    def __init__(self):
        super().__init__()
        self.Conv3d_1a = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b = Unit3D(64, 64)
        self.Conv3d_2c = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, ch in _MIXED.items():
            block = InceptionBlock(cin, ch)
            self.add_module(name, block)
            cin = block.out_channels

    def forward(self, x):
        x = x.float().permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c(self.Conv3d_2b(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        return x.mean(dim=(2, 3, 4))


class FallbackNet(nn.Module):
    """Four "SAME" 3x3x3 convolutions with biases and ReLUs (32, 64, 128 and
    256 channels, strides 1, 2, 2, 2), then the mean over time and space."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, c in enumerate((32, 64, 128, 256)):
            self.add_module(f"Conv_{i}", _Conv(cin, c, (3, 3, 3), bias=True))
            cin = c

    def forward(self, x):
        x = x.float().permute(0, 4, 1, 2, 3)
        for i in range(4):
            conv = getattr(self, f"Conv_{i}")
            s = (1 if i == 0 else 2,) * 3
            x = torch.relu(F.conv3d(same_pad(x, (3, 3, 3), s), conv.weight, conv.bias, s))
        return x.mean(dim=(2, 3, 4))


@torch.no_grad()
def init_random(net, seed=0):
    """Seeded random parameters in the manner of flax's initializers: conv
    weights N(0, 1 / fan_in), conv biases 0, batch norms the identity.
    Drawn from ``torch.Generator``, so not JAX's numbers. Returns ``net``."""
    g = torch.Generator(device=next(net.parameters()).device).manual_seed(seed)
    for m in net.modules():
        if isinstance(m, _Conv):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.zero_()
    return net


def load_i3d(npz_path: str) -> dict:
    """The flat ``{"params/...": array, "batch_stats/...": array}`` of the
    I3D variables in ``npz_path`` (``export_i3d``'s pickled ``variables``
    tree, or a flat npz)."""
    with np.load(npz_path, allow_pickle=True) as raw:
        if "variables" not in raw.files:
            return {k: raw[k] for k in raw.files}
        tree = raw["variables"].item()
    flat = {}

    def rec(d, pre):
        for k, v in d.items():
            key = f"{pre}/{k}" if pre else str(k)
            if isinstance(v, dict):
                rec(v, key)
            else:
                flat[key] = np.asarray(v, np.float32)

    rec(tree, "")
    return flat


class Embedder:
    """A frozen video network as a callable: ``(B, T, H, W, 3)`` (numpy or
    tensor) in [-1, 1] -> ``(B, D)`` fp32 on ``device``."""

    def __init__(self, net, device):
        self.net = net.to(device).eval()
        self.device = device

    @torch.no_grad()
    def __call__(self, vids):
        return self.net(torch.as_tensor(vids).to(self.device))


def make_i3d_embedder(npz_path: Optional[str] = None, seed: int = 0, device=None) -> Embedder:
    """The I3D embedder of ``npz_path`` or, without one, of seeded random
    filters. A given path that does not exist raises."""
    from ccvs_tpu_torch.weights import load_params

    device = resolve_device(device)
    net = I3D()
    if npz_path:
        if not os.path.exists(npz_path):
            raise FileNotFoundError(f"--i3d-npz {npz_path!r} does not exist")
        load_params(net, load_i3d(npz_path))
    else:
        init_random(net, seed)
    return Embedder(net, device)


def make_fallback_embedder(seed: int = 0, device=None) -> Embedder:
    """The fixed random 3D-conv embedder: deterministic, discriminative
    enough to track a distribution distance during development."""
    device = resolve_device(device)
    return Embedder(init_random(FallbackNet(), seed), device)


@torch.no_grad()
def embeddings_from_videos(vids, embed: Callable, batch: int = 16,
                           resize: Optional[int] = 224) -> np.ndarray:
    """``(N, T, H, W, 3)`` in [-1, 1] -> ``(N, D)`` fp32 numpy: each batch
    crosses to the embedder's device at its own size, is resized there to
    ``resize`` square (antialiased bilinear, as ``jax.image.resize``), and
    only its embeddings come back."""
    device = getattr(embed, "device", None)
    outs = []
    for i in range(0, len(vids), batch):
        x = vids[i:i + batch]
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        x = (x if device is None else x.to(device)).float()
        if resize and x.shape[2] != resize:
            x = resize_bilinear(x, resize, resize)
        outs.append(embed(x).float().cpu().numpy())
    return np.concatenate(outs)


_UNCAL_WARNING = (
    "=" * 70 + "\n"
    "WARNING: no vendored I3D weights -- FVD computed with a RANDOM embedder.\n"
    "The numbers are self-consistent (usable for tracking relative progress)\n"
    "but NOT comparable to published I3D-FVD. Export real weights with\n"
    "`python -m ccvs_tpu_torch.port.export_i3d` and pass --i3d-npz.\n" + "=" * 70
)


def fvd_from_videos(real, fake, embed: Optional[Callable] = None,
                    i3d_npz: Optional[str] = None, chunk: Optional[int] = None,
                    resize: Optional[int] = 224, calibrated: Optional[bool] = None,
                    device=None) -> dict:
    """FVD between two video sets, with mean and std over ``chunk``-sized
    groups when asked.

    Without I3D weights (no ``embed``, no ``i3d_npz``) the random fallback
    embedder runs: a warning says so and every key ends in
    ``_uncalibrated``. A given ``i3d_npz`` that does not exist raises."""
    if i3d_npz and not os.path.exists(i3d_npz):
        raise FileNotFoundError(f"--i3d-npz {i3d_npz!r} does not exist")
    if calibrated is None:
        # an explicit embedder or I3D weights count as calibrated; callers
        # that share a fallback embedder (eval-all) pass calibrated=False
        calibrated = embed is not None or bool(i3d_npz)
    if embed is None:
        if calibrated:
            embed = make_i3d_embedder(i3d_npz, device=device)
        else:
            print(_UNCAL_WARNING, file=sys.stderr)
            embed = make_fallback_embedder(device=device)
    key = "fvd" if calibrated else "fvd_uncalibrated"
    a = embeddings_from_videos(real, embed, resize=resize)
    b = embeddings_from_videos(fake, embed, resize=resize)
    out = {key: frechet_distance(a, b), "fallback_embedder": not calibrated}
    if chunk:
        vals = [frechet_distance(a[i:i + chunk], b[i:i + chunk])
                for i in range(0, len(a) - chunk + 1, chunk)]
        if vals:
            out[key + "_mean"] = float(np.mean(vals))
            out[key + "_std"] = float(np.std(vals))
        else:
            out[key + "_chunk_note"] = (
                f"n={len(a)} < chunk={chunk}: no per-chunk mean/std; "
                "the headline key is the full-set distance")
    return out
