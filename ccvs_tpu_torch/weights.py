"""Load the JAX package's parameters into the port's modules.

Input is a flat ``{"a/b/c": array}`` dict, the format of
``ccvs_tpu/port/npz_params.py:flatten_params`` (or an ``.npz`` holding one),
read with numpy alone. Translation:

- flax ``Dense`` ``kernel (in, out)`` -> ``weight (out, in)``;
- flax ``LayerNorm`` ``scale`` and ``Embed`` ``embedding`` -> ``weight``;
- the GPT blocks, stacked by ``nn.scan`` under ``core/blocks/block`` with a
  leading layer axis, -> ``core.blocks.<layer>``;
- flax ``Conv`` ``kernel (*spatial, in, out)`` -> ``weight (out, in,
  *spatial)`` (the I3D and the fallback FVD embedder); the autoencoder's and
  the discriminators' conv weights are already in torch layout and load as
  they are;
- flax ``BatchNorm``: ``scale`` / ``bias`` -> ``weight`` / ``bias``, its
  ``batch_stats`` ``mean`` / ``var`` -> the buffers ``running_mean`` /
  ``running_var``; a leading ``params/`` or ``batch_stats/`` (the
  collections of a flax ``variables`` dict) is dropped;
- raw parameters (the GPT's positional ``s_emb``, ``h_emb``, ``w_emb``,
  ``t_emb``, ``pos_emb``, ``state_s_emb``, ``state_pos_emb``, its
  ``start_tok_emb``, a codebook's ``embedding``) keep their names, so the
  state model's tree
  (``estimator/...``, ``quantizer/embedding``) loads into ``StateModel`` and
  the STFT model's (``encoder/...``, ``quantizer/embedding``,
  ``decoder/...``) into ``StftModel`` as they are; the GPT's ``lbl_emb`` is an
  ``Embed`` like ``tok_emb``. The continuous GPT's ``tok_emb`` is a Dense
  (``tok_emb/kernel``, transposed, and ``tok_emb/bias``) and its head one
  without bias (``head/kernel``); only Dense kernels are transposed.

The autoencoder's decoder options keep the JAX package's names both ways:
``inter_block{i}/matching/deform_weight`` and ``deform_bias`` (the
deformable conv), ``matching/upsample_toff/weight`` (the tradeoff
features), ``to_rgb{i}/conv/conv/*`` and ``to_rgb{i}/bias`` (skip-RGB);
with ``use_inter`` off there is no ``inter_block*`` on either side.

One flat dict of a whole serving set (``ae/...``, ``gpt/...``, ``state/...``,
``stft/...``) loads model by model with ``prefix``. The discriminators
(``di/...``, ``dv/...``, ``df/...`` into an ``nn.ModuleDict`` of them) and
VGG (``conv{i}/weight``, ``conv{i}/bias``) keep the JAX names as they are.

Every parameter and persistent buffer of the module must be filled and
every key must land, or loading raises.

:func:`export_params` is the reverse: a module's parameters as that flat
dict, so that parameters the port trains load into the JAX package
(``npz_params.unflatten_params``): the GPT's, and the autoencoder's raw
generator and EMA (``FrameAutoencoder`` modules) as the ``ae_gen`` tree.
"""

import re

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}
_COLLECTIONS = ("params", "batch_stats")


def _translate(key, value, targets):
    """Yield ``(parameter name, array)`` for one flat key."""
    parts = key.split("/")
    if parts[0] in _COLLECTIONS:
        parts = parts[1:]
    for i in range(len(parts) - 1):
        if parts[i:i + 2] == ["blocks", "block"]:
            for layer in range(value.shape[0]):
                sub = parts[:i + 1] + [str(layer)] + parts[i + 2:]
                yield from _translate("/".join(sub), value[layer], targets)
            return
    name = ".".join(parts)
    if name not in targets and parts[-1] in _LEAF:
        name = ".".join(parts[:-1] + [_LEAF[parts[-1]]])
        if parts[-1] == "kernel" and value.ndim > 2:  # flax Conv (*spatial, in, out)
            value = np.transpose(value, (value.ndim - 1, value.ndim - 2, *range(value.ndim - 2)))
        elif parts[-1] == "kernel":
            value = np.swapaxes(value, -1, -2)
    yield name, value


def load_params(module, flat, prefix=""):
    """Copy the arrays of ``flat`` (keys under ``prefix/`` when given) into
    ``module``'s parameters and persistent buffers, in place. Returns
    ``module``."""
    targets = module.state_dict(keep_vars=True)
    filled = set()
    pre = prefix + "/" if prefix else ""
    for key, value in flat.items():
        if not key.startswith(pre):
            continue
        for name, arr in _translate(key[len(pre):], np.asarray(value), targets):
            if name not in targets:
                raise KeyError(f"{key}: the module has no parameter or buffer {name!r}")
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


def export_params(module):
    """``module``'s parameters as the JAX package's flat ``{"a/b/c": array}``
    (fp32 numpy): ``nn.Linear`` ``weight (out, in)`` -> ``kernel (in,
    out)``, ``nn.Embedding`` ``weight`` -> ``embedding``, a LayerNorm's
    ``weight`` -> ``scale``, and the per-layer ``blocks.<layer>`` stacked
    back along a leading axis under ``blocks/block``. The reverse of
    :func:`load_params`. Parameters split over a mesh (``parallel/``) are
    gathered whole: a collective, which every rank calls."""
    from ccvs_tpu_torch.nn.gpt import LayerNorm
    from ccvs_tpu_torch.parallel.fsdp import full_tensor, tp_split

    leaf = {nn.Linear: "kernel", nn.Embedding: "embedding", LayerNorm: "scale",
            nn.LayerNorm: "scale"}
    flat = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            full = (f"{mname}." if mname else "") + pname
            a = full_tensor(p.detach(), tp_split(module, full)).float().cpu().numpy()
            if pname == "weight" and type(m) in leaf:
                pname = leaf[type(m)]
                if pname == "kernel":
                    a = np.ascontiguousarray(a.T)
            flat[(f"{mname}." if mname else "") + pname] = a
    out, layers = {}, {}
    for name, a in flat.items():
        m = re.fullmatch(r"(.*\.)?blocks\.(\d+)\.(.*)", name)
        if m is None:
            out[name.replace(".", "/")] = a
        else:
            key = f"{m.group(1) or ''}blocks.block.{m.group(3)}".replace(".", "/")
            layers.setdefault(key, {})[int(m.group(2))] = a
    for key, per_layer in layers.items():
        out[key] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return out
