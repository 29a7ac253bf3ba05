"""Observability (counterpart of ``ccvs_tpu/utils/logging.py``, the
reference's ``tools/logger.py``): scalars to ``metrics.jsonl`` (one JSON
line ``{"t", "step", name: value}`` a scalar) and, where ``tensorboardX``
imports, scalars, image grids, videos (red borders on synthesized frames),
optical flows as HSV and segmentations through its ``SummaryWriter``. The
media calls return at once without a writer, and on ranks other than the
main one."""

import json
import os
import time

import numpy as np
import torch

_COLORMAP = np.array(
    [[128, 64, 128], [244, 35, 232], [230, 150, 140], [70, 70, 70], [102, 102, 156],
     [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 135], [152, 251, 152],
     [230, 150, 140], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70],
     [0, 60, 100], [0, 80, 100], [0, 0, 230], [119, 11, 32]], np.float32,
) / 255.0


def _host(x):
    """A tensor (any device, any dtype) or array -> numpy fp32."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def flow_to_rgb(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) HSV-coded RGB (``tools/logger.py:95-103``),
    in the flow's precision."""
    flow = flow.detach().cpu().numpy() if torch.is_tensor(flow) else np.asarray(flow)
    mag = np.linalg.norm(flow, axis=-1)
    ang = (np.arctan2(flow[..., 1], flow[..., 0]) + np.pi) / (2 * np.pi)
    mag = mag / max(mag.max(), 1e-6)
    hsv = np.stack([ang, np.ones_like(mag), mag], axis=-1)
    # vectorized hsv -> rgb
    i = np.floor(hsv[..., 0] * 6).astype(int) % 6
    f = hsv[..., 0] * 6 - np.floor(hsv[..., 0] * 6)
    v = hsv[..., 2]
    p = np.zeros_like(v)
    q = v * (1 - f)
    t = v * f
    return np.select(
        [i[..., None] == k for k in range(6)],
        [np.stack(x, -1) for x in ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                                   (v, p, q))],
    )


def normalize_img(x, span=(-1, 1), imagenet_norm=False):
    x = _host(x)
    if imagenet_norm:
        x = x * np.array([0.229, 0.224, 0.225]) + np.array([0.485, 0.456, 0.406])
        return np.clip(x, 0, 1)
    x = np.clip(x, span[0], span[1])
    return (x - span[0]) / (span[1] - span[0])


class Logger:
    """The main rank's metrics and media logger (``tools/logger.py:9-103``)."""

    def __init__(self, log_path: str, is_main: bool = True, imagenet_norm: bool = False,
                 log_fps: int = 4, use_tensorboard: bool = True):
        self.is_main = is_main
        self.imagenet_norm = imagenet_norm
        self.log_fps = log_fps
        self.writer = None
        self.jsonl = None
        if is_main:
            os.makedirs(log_path, exist_ok=True)
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self.writer = SummaryWriter(log_path)
                except Exception:
                    self.writer = None
            self.jsonl = open(os.path.join(log_path, "metrics.jsonl"), "a")

    def log_scalar(self, name, value, step):
        """``t`` is stamped when the value reaches the host: reading a device
        tensor waits for the step that made it."""
        if not self.is_main or value is None:
            return
        v = float(value.item() if torch.is_tensor(value) else value)
        if self.writer:
            self.writer.add_scalar(name, v, step)
        if self.jsonl:
            self.jsonl.write(json.dumps({"t": time.time(), "step": int(step), name: v}) + "\n")

    def log_scalars(self, metrics: dict, step, prefix=""):
        for k, v in metrics.items():
            self.log_scalar(prefix + k, v, step)
        if self.jsonl:
            self.jsonl.flush()

    def log_img(self, name, imgs, nrow, step, normalize=False, span=(-1, 1)):
        """imgs: (N, H, W, C) float, a tensor or an array."""
        if not self.is_main or self.writer is None or imgs is None:
            return
        x = _host(imgs)
        if x.size == 0:
            return
        if normalize:
            x = normalize_img(x, span, self.imagenet_norm)
        if x.shape[-1] == 1:
            x = np.tile(x, (1, 1, 1, 3))
        n, h, w, c = x.shape
        rows = -(-n // nrow)
        grid = np.zeros((rows * h, nrow * w, c), np.float32)
        for i in range(n):
            r, cc = divmod(i, nrow)
            grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = x[i]
        self.writer.add_image(name, grid, step, dataformats="HWC")

    def log_vid(self, name, vids, step, normalize=False, span=(-1, 1), cond_frames=None):
        """vids: (N, T, H, W, C); a red border marks the synthesized frames
        (``tools/logger.py:61-69``)."""
        if not self.is_main or self.writer is None or vids is None:
            return
        x = _host(vids)
        if normalize:
            x = normalize_img(x, span, self.imagenet_norm)
        if cond_frames is not None:
            for tt in range(cond_frames, x.shape[1]):
                x[:, tt, :2, :, :] = [1, 0, 0]
                x[:, tt, -2:, :, :] = [1, 0, 0]
                x[:, tt, :, :2, :] = [1, 0, 0]
                x[:, tt, :, -2:, :] = [1, 0, 0]
        # tensorboardX takes (N, T, C, H, W)
        v = np.transpose(x, (0, 1, 4, 2, 3))
        self.writer.add_video(name, (v * 255).astype(np.uint8), step, fps=self.log_fps)

    def log_flow(self, name, flows, nrow, step):
        if not self.is_main or self.writer is None or flows is None:
            return
        f = _host(flows)
        if f.size == 0:
            return
        rgb = np.stack([flow_to_rgb(fi) for fi in f])
        self.log_img(name, rgb * 2 - 1, nrow, step, normalize=True)

    def log_seg(self, name, segs, n_classes, nrow, step):
        if not self.is_main or self.writer is None or segs is None:
            return
        s = (segs.detach().cpu().numpy() if torch.is_tensor(segs) else np.asarray(segs)).astype(int)
        if s.size == 0:
            return
        rgb = _COLORMAP[s % len(_COLORMAP)]
        self.log_img(name, rgb * 2 - 1, nrow, step, normalize=True)

    def close(self):
        if self.writer:
            self.writer.close()
            self.writer = None
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
