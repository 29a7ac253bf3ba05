"""7x7 local cost volume (counterpart of ``ccvs_tpu/ops/correlation.py``), NHWC.

  out[b, y, x, (dy+3)*7 + (dx+3)] =
      mean_c first[b, y*s, x*s, c] * second[b, y*s + dy*s, x*s + dx*s, c]

with zeros outside ``second``; output spatial size ``ceil(H/s)``, ``ceil(W/s)``.
"""

import torch
import torch.nn.functional as F


def local_correlation(first, second, stride=1):
    """first, second ``(B, H, W, C)`` -> ``(B, ceil(H/s), ceil(W/s), 49)``."""
    c = first.shape[-1]
    # every sampled position lies on the stride grid: stride s is stride 1 on
    # the pre-strided planes
    q = first[:, ::stride, ::stride]
    kd = second[:, ::stride, ::stride]
    ho, wo = q.shape[1], q.shape[2]
    k = F.pad(kd, (0, 0, 3, 3, 3, 3))
    vols = []
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            shifted = k[:, 3 + dy:3 + dy + ho, 3 + dx:3 + dx + wo]
            vols.append((q * shifted).sum(-1) * (1.0 / c))
    return torch.stack(vols, dim=-1)
