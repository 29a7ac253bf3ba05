"""Checkpoints with latest / best semantics (counterpart of
``ccvs_tpu/utils/checkpoint.py``), stored with ``torch.save``.

The resolution rules are the JAX package's:

- ``save(..., latest=True)`` keeps a rolling latest (the old one deleted);
- ``save(..., best=True)`` keeps the best evaluation's checkpoint;
- ``load(label, "latest" | "best" | step)`` resolves like the reference's
  glob; if a crash left two rolling files of a kind, the highest step wins.

Crash safety: each file is written to a temporary name and renamed into
place, and a rolling predecessor is deleted only after its replacement is
on disk, so a kill at any point leaves a loadable latest.

``npz_mirror`` writes the JAX package's flat fp16 npz beside the checkpoints
(``ccvs_tpu/port/npz_params.py``: keys ``prefix/a/b/c``, floats in fp16,
other prefixes of the file kept), so a GPT that the port trains loads into
the JAX package.
"""

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch


def flatten_params(flat: Dict[str, np.ndarray], prefix: str = "",
                   dtype=np.float16) -> Dict[str, np.ndarray]:
    """``{a/b: array}`` -> ``{prefix/a/b: array}``, floating arrays cast to
    ``dtype`` (integers keep theirs)."""
    out = {}
    for key, a in flat.items():
        a = np.asarray(a)
        if dtype is not None and np.issubdtype(a.dtype, np.floating):
            a = a.astype(dtype)
        out[f"{prefix}/{key}" if prefix else key] = a
    return out


def update_params_npz(path: str, **trees: Dict[str, np.ndarray]) -> None:
    """Merge-write flat trees ``name={a/b: array}`` into the npz at ``path``
    under the prefixes ``name/``, keeping the file's other prefixes; written
    to a temporary file and renamed into place."""
    flat: Dict[str, np.ndarray] = {}
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                flat = {k: z[k] for k in z.files if k.split("/", 1)[0] not in trees}
        except (OSError, ValueError):
            flat = {}  # a corrupt or partial file: replaced by the new trees
    for name, tree in trees.items():
        flat.update(flatten_params(tree, name))
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


class CheckpointManager:
    """Checkpoints of a run under ``path``, one file a checkpoint:
    ``{label}_{step:08d}.pt``, ``{label}_latest_{step:08d}.pt``,
    ``{label}_best_{step:08d}.pt``.

    ``npz_mirror=(npz_path, extract)``: after every ``latest`` write, also
    merge-write ``extract(tree)`` (``{name: flat dict}``) into ``npz_path``
    with :func:`update_params_npz`."""

    def __init__(self, path: str, npz_mirror=None):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)
        self.npz_mirror = npz_mirror

    def _file(self, label: str, step: int, kind: str = "") -> str:
        kind = f"{kind}_" if kind else ""
        return os.path.join(self.path, f"{label}_{kind}{step:08d}.pt")

    def _find(self, label: str, kind: str = "") -> list:
        kind = f"{kind}_" if kind else ""
        pat = re.compile(rf"^{re.escape(label)}_{kind}(\d+)\.pt$")
        out = []
        for f in os.listdir(self.path):
            m = pat.match(f)
            if m:
                out.append((int(m.group(1)), os.path.join(self.path, f)))
        return sorted(out)

    def save(self, label: str, step: int, tree: Any, latest: bool = False,
             best: bool = False):
        """Save ``tree`` (tensors, arrays, numbers in dicts, as
        ``state_dict()``s give them); with ``latest`` / ``best`` keep rolling
        copies."""
        kinds = [k for k, on in (("latest", latest), ("best", best)) if on] or [""]
        for kind in kinds:
            f = self._file(label, step, kind)
            olds = [p for _, p in (self._find(label, kind) if kind else []) if p != f]
            tmp = f + ".tmp"
            torch.save(tree, tmp)
            os.replace(tmp, f)
            # predecessors go only once the replacement is on disk
            for p in olds:
                os.remove(p)
        if latest and self.npz_mirror is not None:
            npz_path, extract = self.npz_mirror
            update_params_npz(npz_path, **extract(tree))

    def record_best(self, label: str, step: int, metric: float):
        """Persist the best checkpoint's metric, so that a resumed run does
        not reset its best to +inf."""
        with open(os.path.join(self.path, f"{label}_best_metric.json"), "w") as f:
            json.dump({"step": step, "metric": metric}, f)

    def best_metric(self, label: str) -> float:
        try:
            with open(os.path.join(self.path, f"{label}_best_metric.json")) as f:
                return float(json.load(f)["metric"])
        except (OSError, ValueError, KeyError):
            return float("inf")

    def load(self, label: str, which="latest", target=None, map_location="cpu"):
        """The checkpoint ``which`` ("latest", "best" or a step) of
        ``label``; loaded into ``target`` (anything with ``load_state_dict``)
        and ``target`` returned, where one is given."""
        if which in ("latest", "best"):
            found = self._find(label, which)
            if not found:
                raise FileNotFoundError(f"no {which} checkpoint for {label} in {self.path}")
            f = found[-1][1]
        else:
            f = self._file(label, int(which))
            if not os.path.isfile(f):
                raise FileNotFoundError(f)
        tree = torch.load(f, map_location=map_location, weights_only=True)
        if target is None:
            return tree
        target.load_state_dict(tree)
        return target

    def step_of(self, label: str, which="latest") -> int:
        found = self._find(label, which if which in ("latest", "best") else "")
        return found[-1][0] if found else 0
