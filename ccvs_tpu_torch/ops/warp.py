"""Bilinear backwarp (counterpart of ``ccvs_tpu/ops/warp.py``), NHWC.

``grid_sample`` is ``F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=False)``, which is what the JAX package reproduces with
gathers; its TPU tiling work-arounds (``_grid_sample_planes``, the int8
source path) have no counterpart here, only their results.
"""

import torch
import torch.nn.functional as F


def make_backwarp_grid(height, width, dtype=torch.float32, device=None):
    """Pixel-centre normalised grid ``(H, W, 2)``, ``[..., 0] = x``."""
    xs = torch.linspace(-1.0 + 1.0 / width, 1.0 - 1.0 / width, width, dtype=dtype, device=device)
    ys = torch.linspace(-1.0 + 1.0 / height, 1.0 - 1.0 / height, height, dtype=dtype, device=device)
    gx = xs[None, :].expand(height, width)
    gy = ys[:, None].expand(height, width)
    return torch.stack([gx, gy], dim=-1)


def grid_sample(x, grid):
    """x ``(B, Hin, Win, C)``; grid ``(B, Hout, Wout, 2)`` normalised (x, y)
    -> ``(B, Hout, Wout, C)``; bilinear, zeros outside, align_corners=False.

    Sampled in fp32: ``F.grid_sample`` wants the grid in the input's dtype,
    and a bf16 grid would place samples up to half a pixel off at 256 px."""
    out = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _sample_grid(flow, h, w, grid):
    fx = flow[..., 0] / ((w - 1) / 2.0)
    fy = flow[..., 1] / ((h - 1) / 2.0)
    return grid[None] + torch.stack([fx, fy], dim=-1).float()


def backwarp(x, flow, grid=None):
    """Warp ``x`` ``(B, H, W, C)`` backwards along ``flow`` ``(B, H, W, 2)``
    (pixels, ``[..., 0] = x``); flow-x is normalised by ``(W-1)/2``, flow-y by
    ``(H-1)/2``."""
    _, h, w, _ = x.shape
    if grid is None:
        grid = make_backwarp_grid(h, w, device=x.device)
    return grid_sample(x, _sample_grid(flow, h, w, grid))


def backwarp_sampled(x, flow, stride):
    """``backwarp(x, flow)[:, ::stride, ::stride]``, sampling only those
    positions."""
    _, h, w, _ = x.shape
    grid = make_backwarp_grid(h, w, device=x.device)[::stride, ::stride]
    return grid_sample(x, _sample_grid(flow[:, ::stride, ::stride], h, w, grid))
