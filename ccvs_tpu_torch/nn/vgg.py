"""VGG19 (or VGG16) features for the perceptual loss (counterpart of
``ccvs_tpu/nn/vgg.py``): the first 30 layers of torchvision's ``features``,
five slices, the weighted L1 distance of the reference's ``perceptual.py``.

Computed in fp32 whatever the caller's dtype. Weights come from an npz with
torchvision's keys (``features.{i}.weight``, what the JAX package's
``export_vgg`` writes) or, as the JAX package's fallback, seeded random He
filters: no pretrained weights ship with the repository, and a loss on
random filters is a usable training signal but not the reference's. The
parameters are named ``conv{i}.weight`` / ``conv{i}.bias`` after the JAX
package's tree (``conv{i}/weight``), so its trees load with
``weights.load_params``.
"""

import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_CFG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"]
_CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
# the five slices end after these feature layers (relu1_2 ... relu5_1 of vgg19)
_SLICE_ENDS = {"vgg19": (2, 7, 12, 21, 30), "vgg16": (4, 9, 16, 23, 30)}
_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def layer_plan(arch="vgg19"):
    """``[(kind, in_ch, out_ch)]`` of torchvision's ``{arch}.features[0:30]``."""
    plan, in_ch = [], 3
    for c in (_CFG19 if arch == "vgg19" else _CFG16):
        if c == "M":
            plan.append(("pool", None, None))
        else:
            plan += [("conv", in_ch, c), ("relu", None, None)]
            in_ch = c
    return plan[:30]


class VGG(nn.Module):
    """The feature layers; ``conv{i}`` is feature layer ``i``. Frozen: its
    parameters take no gradient."""

    def __init__(self, arch="vgg19", device=None):
        super().__init__()
        self.arch = arch
        for i, (kind, cin, cout) in enumerate(layer_plan(arch)):
            if kind == "conv":
                conv = nn.Module()
                conv.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, device=device),
                                           requires_grad=False)
                conv.bias = nn.Parameter(torch.zeros(cout, device=device), requires_grad=False)
                self.add_module(f"conv{i}", conv)

    def features(self, x):
        """The five slice activations, NCHW (channels-last strides), of NHWC
        frames in [-1, 1]."""
        mean = x.new_tensor(_MEAN, dtype=torch.float32)
        std = x.new_tensor(_STD, dtype=torch.float32)
        # [-1, 1] -> ImageNet normalization (the LPIPS scaling layer)
        x = ((x.float() + 1.0) * 0.5 - mean) / std
        x = x.permute(0, 3, 1, 2)
        outs, ends = [], _SLICE_ENDS[self.arch]
        for i, (kind, _, _) in enumerate(layer_plan(self.arch)):
            if kind == "conv":
                conv = getattr(self, f"conv{i}")
                x = F.conv2d(x, conv.weight, conv.bias, padding=1)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2)
            if i + 1 in ends:
                outs.append(x)
        return outs


def vgg_loss(vgg, fake, real):
    """Weighted L1 of the five slices' features (``perceptual.py:44-52``);
    ``real`` takes no gradient."""
    with torch.no_grad():
        fr = vgg.features(real)
    loss = 0.0
    for w, a, b in zip(_WEIGHTS, vgg.features(fake), fr):
        loss = loss + w * (a - b).abs().mean()
    return loss


@torch.no_grad()
def init_random(vgg, generator):
    """Seeded He-normal filters, zero biases (the JAX package's fallback).
    Returns ``vgg``."""
    for m in vgg.children():
        cout, cin = m.weight.shape[:2]
        m.weight.normal_(0.0, math.sqrt(2.0 / (cin * 9)), generator=generator)
        m.bias.zero_()
    return vgg


def detect_arch(keys):
    """vgg19 has a conv at ``features[16]``, vgg16 a pool."""
    return "vgg19" if "features.16.weight" in keys else "vgg16"


def load_vgg_npz(path, device=None):
    """``(vgg, lins)``: a :class:`VGG` of the weights in an npz with
    torchvision's keys (either architecture), and the five LPIPS channel
    weights ``lin0`` ... ``lin4`` (flat fp32 tensors) of the JAX package's
    ``export_lpips`` format, or None when the npz has none."""
    with np.load(path) as raw:
        vgg = VGG(detect_arch(raw.files), device=device)
        with torch.no_grad():
            for name, m in vgg.named_children():
                i = name[len("conv"):]
                m.weight.copy_(torch.from_numpy(raw[f"features.{i}.weight"]))
                m.bias.copy_(torch.from_numpy(raw[f"features.{i}.bias"]))
        lins = None
        if "lin0" in raw.files:
            lins = [torch.from_numpy(np.asarray(raw[f"lin{k}"], np.float32).reshape(-1)).to(
                vgg.conv0.weight.device) for k in range(5)]
    return vgg, lins


def make_vgg(npz=None, seed=0, device=None, context="the perceptual loss"):
    """The VGG of ``npz`` or, without one, seeded random filters, with a
    warning that says so. A path that is given but missing raises: a typo
    must not send a run down the random-filter path."""
    if npz:
        if not os.path.exists(npz):
            raise FileNotFoundError(f"vgg npz {npz!r} does not exist")
        return load_vgg_npz(npz, device=device)[0]
    print(f"WARNING: no VGG weights given -- {context} uses fixed random filters (seed "
          f"{seed}), not the reference's pretrained VGG", file=sys.stderr)
    vgg = VGG(device=device)
    return init_random(vgg, torch.Generator(device=vgg.conv0.weight.device).manual_seed(seed))
