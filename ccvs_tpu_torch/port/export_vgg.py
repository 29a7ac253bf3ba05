"""Export torchvision VGG19 weights to an npz for the perceptual loss
(counterpart of ``ccvs_tpu/port/export_vgg.py``, the same keys and arrays).

Run on a machine with network access / torchvision installed:
    python -m ccvs_tpu_torch.port.export_vgg vgg19.npz
then pass ``--vgg-npz vgg19.npz`` to the trainers / eval.
"""

import sys

import numpy as np


def main(out_path: str):
    import torchvision

    vgg = torchvision.models.vgg19(weights="IMAGENET1K_V1")
    sd = vgg.state_dict()
    arrays = {k: v.numpy() for k, v in sd.items() if k.startswith("features.")}
    np.savez(out_path, **arrays)
    print(f"wrote {len(arrays)} arrays to {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "vgg19.npz")
