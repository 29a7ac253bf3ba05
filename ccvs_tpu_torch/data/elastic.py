"""Elastic-view augmentation: self-supervised optical-flow ground truth.
The port's own copy of ``ccvs_tpu/data/elastic.py``, unchanged.

NumPy/SciPy port of `data/augmentations.py` (reference): gaussian-filtered
random displacement fields scaled by alpha, optional zoom flow, approximate
flow inversion (scatter + iterative gaussian hole-filling), corruption masks,
and gaussian pre-blur of the context image. Host-side per-sample CPU work,
exactly like the reference's dataloader workers. All images NHWC float32.
"""

import math
import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter


def _grid(height, width):
    xs = np.linspace(-1 + 1 / width, 1 - 1 / width, width, dtype=np.float32)
    ys = np.linspace(-1 + 1 / height, 1 - 1 / height, height, dtype=np.float32)
    return np.meshgrid(xs, ys)  # gx (H, W), gy (H, W)


def backwarp_np(img, flow, padding_value=0.0, mode="bilinear"):
    """NumPy bilinear backwarp, torch grid_sample(align_corners=False, zeros)
    semantics. img (H, W, C), flow (H, W, 2) in pixels."""
    h, w = img.shape[:2]
    gx, gy = _grid(h, w)
    sx = gx + flow[..., 0] / ((w - 1) / 2.0)
    sy = gy + flow[..., 1] / ((h - 1) / 2.0)
    ix = ((sx + 1) * w - 1) / 2.0
    iy = ((sy + 1) * h - 1) / 2.0
    x0 = np.floor(ix).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    wx = (ix - x0)[..., None]
    wy = (iy - y0)[..., None]
    src = img - padding_value

    src_flat = src.reshape(-1, src.shape[-1])

    def gather(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = np.clip(yy, 0, h - 1) * w + np.clip(xx, 0, w - 1)
        return src_flat[idx.reshape(-1)].reshape(*idx.shape, -1) * valid[..., None]

    if mode == "nearest":
        xx = np.round(ix).astype(np.int64)
        yy = np.round(iy).astype(np.int64)
        out = gather(yy, xx)
    else:
        out = (
            gather(y0, x0) * (1 - wx) * (1 - wy)
            + gather(y0, x0 + 1) * wx * (1 - wy)
            + gather(y0 + 1, x0) * (1 - wx) * wy
            + gather(y0 + 1, x0 + 1) * wx * wy
        )
    return out + padding_value


def get_zoom_flow(zoom, height, width, adapt_to_scale=True):
    """`augmentations.py:21-32`."""
    if zoom >= 1 and adapt_to_scale:
        tgt_h, tgt_w = height / zoom, width / zoom
    else:
        tgt_h, tgt_w = zoom * height, zoom * width
    dh, dw = height - tgt_h, width - tgt_w
    zoom_dx = dw / 2 - np.arange(width, dtype=np.float32) * dw / (width - 1)
    zoom_dy = dh / 2 - np.arange(height, dtype=np.float32) * dh / (height - 1)
    return zoom_dx, zoom_dy


def _gaussian_kernel(k):
    c = np.arange(k, dtype=np.float32)
    xg, yg = np.meshgrid(c, c)
    mean = (k - 1) / 2.0
    var = (k / 6.0) ** 2
    g = np.exp(-((xg - mean) ** 2 + (yg - mean) ** 2) / (2 * var))
    return g / g.sum()


def approx_flow_inversion(flow, k=3, max_iters=64):
    """Scatter-based flow inversion with iterative hole filling
    (`augmentations.py:181-220`). flow: (H, W, 2)."""
    h, w = flow.shape[:2]
    dx, dy = flow[..., 0].reshape(-1), flow[..., 1].reshape(-1)
    xg = np.tile(np.arange(w, dtype=np.float32), h) + dx
    yg = np.repeat(np.arange(h, dtype=np.float32), w) + dy
    xg[(xg < 0) | (xg > w - 1)] = 0
    yg[(yg < 0) | (yg > h - 1)] = 0
    field = yg.astype(np.int64) * w + xg.astype(np.int64)

    inv_dx = np.zeros(h * w, np.float32)
    inv_dy = np.zeros(h * w, np.float32)
    mask = np.zeros(h * w, bool)
    inv_dx[field] = -dx
    inv_dy[field] = -dy
    mask[field] = True
    inv_dx = inv_dx.reshape(h, w)
    inv_dy = inv_dy.reshape(h, w)
    mask = mask.reshape(h, w)

    kern = _gaussian_kernel(k)
    pad = k // 2

    def conv(x):
        # small-kernel "same" correlation as padded slice accumulation —
        # the gaussian kernel is symmetric so this equals convolve2d, and it
        # is ~5x faster than scipy.signal.convolve2d on the 1-core host
        # (the dataloader hot path: 3 convs per hole-fill iteration).
        xp = np.pad(x.astype(np.float32), pad)
        out = np.zeros_like(x, np.float32)
        for i in range(k):
            for j in range(k):
                out += kern[i, j] * xp[i : i + h, j : j + w]
        return out

    it = 0
    while not mask.all() and it < max_iters:
        new_mask = np.zeros_like(mask)
        new_mask[1:] |= ~mask[1:] & mask[:-1]
        new_mask[:-1] |= ~mask[:-1] & mask[1:]
        new_mask[:, 1:] |= ~mask[:, 1:] & mask[:, :-1]
        new_mask[:, :-1] |= ~mask[:, :-1] & mask[:, 1:]
        ndx, ndy, ns = conv(inv_dx), conv(inv_dy), conv(mask.astype(np.float32))
        sel = new_mask & (ns > 0)
        inv_dx[sel] = ndx[sel] / ns[sel]
        inv_dy[sel] = ndy[sel] / ns[sel]
        mask |= sel
        it += 1
    return np.stack([inv_dx, inv_dy], axis=-1)


@dataclass
class ElasticParams:
    alpha: float = 1.5
    sigma: float = 0.15
    min_zoom: float = 1.0
    max_zoom: float = 1.0
    corruption: bool = False
    mean_corruption: float = 0.5
    blur: Optional[Tuple[float, float]] = None
    invert: bool = False  # distort_first


def get_augmentation(img, dim, p: ElasticParams, rng=None, layout=None):
    """Build (context_img, distorted_img, flow, mask) (`augmentations.py:34-179`).

    Args:
      img: (H, W, 3) float32 in [-1, 1] (full-resolution source frame).
      dim: target output height.
      layout: optional (H, W) int segmentation aligned with ``img``; warped
        with the same flows in nearest mode (`augmentations.py:107-128`) so
        layout twins can train on elastic views.
    Returns:
      context (dim, W', 3), distorted (dim, W', 3), flow (dim, W', 2),
      mask (dim, W', 1) float {0,1} (empty-shape-compatible zeros when
      corruption off). With ``layout``, two extra trailing elements:
      context_layout, distorted_layout — (dim, W') int64.
    """
    rng = rng or np.random.RandomState()
    h, w = img.shape[:2]
    alpha = p.alpha * h
    sigma = p.sigma * h

    dx = gaussian_filter(rng.rand(h, w) * 2 - 1, sigma) * alpha
    dy = gaussian_filter(rng.rand(h, w) * 2 - 1, sigma) * alpha
    dx = dx.astype(np.float32)
    dy = dy.astype(np.float32)

    i_dx = i_dy = None
    if p.invert:
        inv = approx_flow_inversion(np.stack([dx, dy], axis=-1))
        i_dx, i_dy = inv[..., 0], inv[..., 1]

    o_dx = o_dy = None
    zoom = p.min_zoom + rng.rand() * (p.max_zoom - p.min_zoom)
    zdx, zdy = get_zoom_flow(zoom, h, w)
    if p.invert:
        if zoom < 1:
            i_dx = i_dx + zdx[None, :]
            i_dy = i_dy + zdy[:, None]
            o_dx = np.tile(zdx[None, :], (h, 1))
            o_dy = np.tile(zdy[:, None], (1, w))
        else:
            dx = dx + zdx[None, :]
            dy = dy + zdy[:, None]
            izdx, izdy = get_zoom_flow(1 / zoom, h, w, adapt_to_scale=False)
            i_dx = i_dx - izdx[None, :]
            i_dy = i_dy - izdy[:, None]
    else:
        if zoom < 1:
            dx = dx + zdx[None, :]
            dy = dy + zdy[:, None]
        else:
            o_dx = np.tile(zdx[None, :], (h, 1))
            o_dy = np.tile(zdy[:, None], (1, w))

    ctx_layout = dist_layout = None
    lay = layout.astype(np.float32)[..., None] if layout is not None else None
    if p.invert:
        ctx_flow = np.stack([dx, dy], axis=-1)
        context = backwarp_np(img, ctx_flow)
        if o_dx is not None:
            o_flow = np.stack([o_dx, o_dy], axis=-1)
            distorted = backwarp_np(img, o_flow)
        else:
            distorted = img.copy()
        flow = np.stack([i_dx, i_dy], axis=-1)
        if lay is not None:  # same flows, nearest (`augmentations.py:110-119`)
            ctx_layout = backwarp_np(lay, ctx_flow, mode="nearest")
            dist_layout = (
                backwarp_np(lay, o_flow, mode="nearest") if o_dx is not None else lay.copy()
            )
    else:
        d_flow = np.stack([dx, dy], axis=-1)
        distorted = backwarp_np(img, d_flow)
        if o_dx is not None:
            o_flow = np.stack([o_dx, o_dy], axis=-1)
            context = backwarp_np(img, o_flow)
            flow = np.stack([dx - o_dx, dy - o_dy], axis=-1)
        else:
            context = img.copy()
            flow = d_flow
        if lay is not None:  # (`augmentations.py:120-128`)
            dist_layout = backwarp_np(lay, d_flow, mode="nearest")
            ctx_layout = (
                backwarp_np(lay, o_flow, mode="nearest") if o_dx is not None else lay.copy()
            )

    # rescale to training dim
    f = None
    if dim != h:
        f = dim / h
        tgt = (dim, int(w * dim / h))
        context = _resize(context, tgt)
        distorted = _resize(distorted, tgt)
        if lay is not None:  # nearest for segmentations (`augmentations.py:141-146`)
            ctx_layout = _resize_nearest(ctx_layout, tgt)
            dist_layout = _resize_nearest(dist_layout, tgt)
    else:
        tgt = (h, w)

    if p.blur is not None:
        s1, s2 = p.blur
        s = s1 + (s2 - s1) * random.random()
        if s > 1e-3:
            context = np.stack(
                [gaussian_filter(context[..., c], s, truncate=2.0) for c in range(context.shape[-1])],
                axis=-1,
            )

    if p.corruption:
        corr_level = 1 - 2 * p.mean_corruption
        corr = (gaussian_filter(rng.rand(h, w) * 2 - 1, sigma) * alpha > corr_level)
        mask = backwarp_np(corr.astype(np.float32)[..., None], flow, padding_value=1.0)
        corr_r = _resize(corr.astype(np.float32)[..., None], tgt)
        context = context * (1 - corr_r)
        mask = (_resize(mask, tgt) > 0.5).astype(np.float32)
    else:
        mask = np.zeros((*tgt, 1), np.float32)

    if f is not None:
        flow = _resize(flow * f, tgt)

    out = (
        context.astype(np.float32),
        distorted.astype(np.float32),
        flow.astype(np.float32),
        mask,
    )
    if lay is not None:
        out = out + (
            ctx_layout[..., 0].astype(np.int64),
            dist_layout[..., 0].astype(np.int64),
        )
    return out


def _resize(img, tgt, method=None):
    """Per-channel PIL resize (H, W, C) -> tgt; bilinear unless ``method``
    (segmentation maps pass Image.NEAREST)."""
    from PIL import Image

    method = Image.BILINEAR if method is None else method
    chans = [
        np.asarray(
            Image.fromarray(img[..., c].astype(np.float32), mode="F").resize(
                (tgt[1], tgt[0]), method
            )
        )
        for c in range(img.shape[-1])
    ]
    return np.stack(chans, axis=-1)


def _resize_nearest(img, tgt):
    from PIL import Image

    return _resize(img, tgt, Image.NEAREST)
