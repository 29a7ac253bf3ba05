"""Export the calibrated LPIPS 'vgg' network to one npz (counterpart of
``ccvs_tpu/port/export_lpips.py``, the same keys and arrays).

The reference scores LPIPS via piq (`tools/pytorch_metrics/metrics.py:12,46`),
whose network is torchvision VGG16 features with the richzhang
PerceptualSimilarity learned per-slice linear weights ("lin" checkpoint,
``lpips/weights/v0.1/vgg.pth``: keys ``lin{k}.model.1.weight`` of shape
(1, C, 1, 1)). This bundles both into a single npz consumable by
``ccvs_tpu_torch.eval.metrics`` LPIPS via ``--vgg-npz``.

Run where torchvision + the lin checkpoint are available:
    python -m ccvs_tpu_torch.port.export_lpips vgg_lin.pth lpips_vgg.npz
"""

import re
import sys

import numpy as np


def translate_lin(lin_sd) -> dict:
    """richzhang lin state dict -> {"lin0".."lin4": (C,) arrays}."""
    out = {}
    for k, v in lin_sd.items():
        m = re.match(r"lin(\d)\.model\.(\d+)\.weight", k)
        if not m:
            continue
        out[f"lin{m.group(1)}"] = np.asarray(v).reshape(-1)
    if sorted(out) != [f"lin{k}" for k in range(5)]:
        raise ValueError(f"expected lin0..lin4 in checkpoint, got {sorted(out)}")
    return out


def main(lin_path: str, out_path: str = "lpips_vgg.npz"):
    import torch
    import torchvision

    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1")
    feats = {k: v.numpy() for k, v in vgg.state_dict().items()
             if k.startswith("features.")}
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    lins = translate_lin(lin_sd)
    np.savez(out_path, **feats, **lins)
    print(f"wrote {len(feats)} feature arrays + {len(lins)} lin weights to {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
