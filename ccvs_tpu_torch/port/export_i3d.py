"""Translate pytorch-i3d checkpoint weights into the I3D variables npz for
FVD (counterpart of ``ccvs_tpu/port/export_i3d.py``, the same keys and
arrays, so a file made by either package loads into both).

The reference evaluates FVD with the tf.hub I3D
(`tools/tf_fvd/fvd.py:63-122`); the common public torch port
(piergiaj/pytorch-i3d, `rgb_imagenet.pt`) uses module names like
``Mixed_3b.b1a.conv3d.weight``. This maps them onto the I3D variables tree
(flax's layout: kernels ``(kt, kh, kw, in, out)``, batch-norm ``scale`` /
``bias`` under ``params`` and ``mean`` / ``var`` under ``batch_stats``)
and saves it pickled under the key ``variables``, the npz that
``ccvs_tpu_torch.eval.fvd.load_i3d`` and ``--i3d-npz`` read.

Run where the .pt file is available:
    python -m ccvs_tpu_torch.port.export_i3d rgb_imagenet.pt i3d.npz
"""

import sys

import numpy as np

_BRANCH = {
    "b0": "Branch_0",
    "b1a": "Branch_1a",
    "b1b": "Branch_1b",
    "b2a": "Branch_2a",
    "b2b": "Branch_2b",
    "b3b": "Branch_3b",
}

# pytorch-i3d endpoint names -> the I3D tree's module names
_ENDPOINT = {
    "Conv3d_1a_7x7": "Conv3d_1a",
    "Conv3d_2b_1x1": "Conv3d_2b",
    "Conv3d_2c_3x3": "Conv3d_2c",
}


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def translate(sd) -> dict:
    """torch-style flat state dict -> {"params": ..., "batch_stats": ...}."""
    params, stats = {}, {}
    for key, val in sd.items():
        parts = key.split(".")
        ep = parts[0]
        if ep.startswith("logits") or ep == "avg_pool":
            continue  # classifier head: FVD uses pooled features only
        if ep in _ENDPOINT:
            scope, rest = (_ENDPOINT[ep],), parts[1:]
        elif ep.startswith("Mixed_"):
            scope, rest = (ep, _BRANCH[parts[1]]), parts[2:]
        else:
            continue
        val = np.asarray(val)
        unit, field = rest[0], rest[1]
        if unit == "conv3d" and field == "weight":
            # torch (O, I, kt, kh, kw) -> flax (kt, kh, kw, I, O)
            _set(params, scope + ("conv3d", "kernel"), val.transpose(2, 3, 4, 1, 0))
        elif unit == "conv3d" and field == "bias":
            _set(params, scope + ("conv3d", "bias"), val)
        elif unit == "bn" and field == "weight":
            _set(params, scope + ("bn", "scale"), val)
        elif unit == "bn" and field == "bias":
            _set(params, scope + ("bn", "bias"), val)
        elif unit == "bn" and field == "running_mean":
            _set(stats, scope + ("bn", "mean"), val)
        elif unit == "bn" and field == "running_var":
            _set(stats, scope + ("bn", "var"), val)
    return {"params": params, "batch_stats": stats}


def main(pt_path: str, out_path: str = "i3d.npz"):
    import torch

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    tree = translate({k: v.numpy() for k, v in sd.items()})
    np.savez(out_path, variables=np.array(tree, dtype=object))
    print(f"wrote i3d variables to {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
