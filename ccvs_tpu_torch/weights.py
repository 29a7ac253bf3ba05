"""Load the JAX package's parameters into the port's modules.

Input is a flat ``{"a/b/c": array}`` dict, the format of
``ccvs_tpu/port/npz_params.py:flatten_params`` (or an ``.npz`` holding one),
read with numpy alone. Translation:

- flax ``Dense`` ``kernel (in, out)`` -> ``weight (out, in)``;
- flax ``LayerNorm`` ``scale`` and ``Embed`` ``embedding`` -> ``weight``;
- the GPT blocks, stacked by ``nn.scan`` under ``core/blocks/block`` with a
  leading layer axis, -> ``core.blocks.<layer>``;
- conv weights are already in torch layout and load as they are;
- raw parameters (``s_emb``, ``state_s_emb``, ``start_tok_emb``, a
  codebook's ``embedding``) keep their names, so the state model's tree
  (``estimator/...``, ``quantizer/embedding``) loads into ``StateModel`` and
  the STFT model's (``encoder/...``, ``quantizer/embedding``,
  ``decoder/...``) into ``StftModel`` as they are; the GPT's ``lbl_emb`` is an
  ``Embed`` like ``tok_emb``.

One flat dict of a whole serving set (``ae/...``, ``gpt/...``, ``state/...``,
``stft/...``) loads model by model with ``prefix``.

Every parameter of the module must be filled and every key must land, or
loading raises.
"""

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _translate(key, value, targets):
    """Yield ``(parameter name, array)`` for one flat key."""
    parts = key.split("/")
    for i in range(len(parts) - 1):
        if parts[i:i + 2] == ["blocks", "block"]:
            for layer in range(value.shape[0]):
                sub = parts[:i + 1] + [str(layer)] + parts[i + 2:]
                yield from _translate("/".join(sub), value[layer], targets)
            return
    name = ".".join(parts)
    if name not in targets and parts[-1] in _LEAF:
        name = ".".join(parts[:-1] + [_LEAF[parts[-1]]])
        if parts[-1] == "kernel":
            value = np.swapaxes(value, -1, -2)
    yield name, value


def load_params(module, flat, prefix=""):
    """Copy the arrays of ``flat`` (keys under ``prefix/`` when given) into
    ``module``'s parameters, in place. Returns ``module``."""
    targets = dict(module.named_parameters())
    filled = set()
    pre = prefix + "/" if prefix else ""
    for key, value in flat.items():
        if not key.startswith(pre):
            continue
        for name, arr in _translate(key[len(pre):], np.asarray(value), targets):
            if name not in targets:
                raise KeyError(f"{key}: the module has no parameter {name!r}")
            p = targets[name]
            if tuple(p.shape) != arr.shape:
                raise ValueError(f"{key} -> {name}: shape {arr.shape}, expected {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.tensor(arr))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"parameters not in the input: {missing}")
    return module


def load_npz(module, path, prefix=""):
    """:func:`load_params` from an ``.npz`` file."""
    with np.load(path) as z:
        return load_params(module, {k: z[k] for k in z.files}, prefix)
