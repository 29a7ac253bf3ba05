"""Load the reference's PyTorch checkpoints into the port's modules
(counterpart of ``ccvs_tpu/port/port_pytorch.py``).

The reference saves one state dict a network, ``{label}_[latest_|best_]net_
{iter}.pth`` (``models/__init__.py:5-26``), with the labels ``qvid_{e,q,g,
di,dv,df}[_ema]``, ``transformer_t``, ``state_{s,q}`` and ``stft_{q,e,d}``.
The ``port_*`` functions translate one into the JAX package's parameter tree
(nested dicts of numpy arrays, the same tree the JAX package's functions
give); :func:`load_ported` flattens it and loads it through
:func:`ccvs_tpu_torch.weights.load_params`, the one name map from that tree
to the port's modules. So each key's transform is the JAX package's:

- ``ConvLayer`` = ``Sequential([Blur]?, EqualConv2d, [Blur]?,
  [LeakyReLU]?)`` (``skip_autoencoder.py:66-102``): its conv weight is at
  index 1 after a Blur (downsampling), else at 0, copied as it is;
- ``ResBlock`` = ``conv1`` / ``conv2`` / ``skip``; the encoder's and
  decoder's ``blocks``, the decoder's ``inter_blocks`` (``Matching`` and
  ``Subpixel`` heads);
- the GPT's ``blocks.{i}.{ln1, ln2, attn.{key, query, value, proj},
  mlp.{0, 3}}`` -> ``core/blocks/block`` stacked over ``i``; every
  ``Linear`` weight ``(out, in)`` -> a Dense ``kernel (in, out)`` (and back
  to ``(out, in)`` in the port's ``nn.Linear``); embeddings
  (``tok_emb.weight`` of the discrete GPT), LayerNorms and the positional
  parameters are copied as they are.

Usage::

    from ccvs_tpu_torch.port import port_pytorch as pp

    sds = {label: pp.load_torch_state_dict(path) for label, path in files.items()}
    pp.load_ported(autoencoder, pp.port_autoencoder(cfg.ae, sds))
    pp.load_ported(transformer.model, pp.port_gpt(cfg.gpt, sds["transformer_t"]))

The ``cfg`` arguments are the port's config groups. The decoder options the
port does not have yet (``use_tradeoff``, ``no_corr``, ``no_proj``,
``use_inter`` off) cannot be set there: ``Config.from_json`` raises on them.
"""

import math
import re

import numpy as np

from ccvs_tpu_torch.nn.decoder import interblock_schedule
from ccvs_tpu_torch.weights import load_params


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _arrays(sd):
    """A state dict's values as numpy arrays (tensors on any device)."""
    return {k: _np(v) for k, v in sd.items()}


def load_torch_state_dict(path):
    """A ``.pth`` state dict as ``{key: numpy array}``. The file is read with
    ``weights_only=True``: one that needs unpickling of other objects raises."""
    import torch

    return _arrays(torch.load(path, map_location="cpu", weights_only=True))


def flatten(tree, prefix=""):
    """A nested parameter tree -> the flat ``{"a/b/c": array}`` that
    :func:`ccvs_tpu_torch.weights.load_params` reads."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_ported(module, tree):
    """Load a ``port_*`` tree into the port's ``module`` (every parameter
    filled, every key used, or it raises); returns ``module``."""
    return load_params(module, flatten(tree))


# ---------------- building blocks ----------------


def _convlayer(sd, prefix, downsample=False, bias=True):
    """The EqualConv2d of a ``ConvLayer``: index 1 after a Blur
    (downsampling), else 0."""
    ci = 1 if downsample else 0
    out = {"conv": {"weight": sd[f"{prefix}.{ci}.weight"]}}
    if bias and f"{prefix}.{ci}.bias" in sd:
        out["conv"]["bias"] = sd[f"{prefix}.{ci}.bias"]
    return out


def _resblock(sd, prefix, down=False):
    return {
        "conv1": _convlayer(sd, f"{prefix}.conv1"),
        "conv2": _convlayer(sd, f"{prefix}.conv2", downsample=down),
        "skip": _convlayer(sd, f"{prefix}.skip", downsample=down, bias=False),
    }


def port_encoder(cfg, sd):
    """``qvid_e`` (or ``qvid_el``) state dict -> the SkipEncoder tree."""
    sd = _arrays(sd)
    n = cfg.num_resolutions
    out = {"block0": _convlayer(sd, "blocks.0")}
    for i in range(1, n):
        out[f"block{i}"] = _resblock(sd, f"blocks.{i}", down=True)
    out[f"block{n}"] = _convlayer(sd, f"blocks.{n}")
    return out


def _matching(sd, prefix, feat_size, first, corr_stride):
    out = {}
    if not first:
        out["upsample_flow"] = {"weight": sd[f"{prefix}.upsample_flow.weight"]}
        out["upsample_occ"] = {"weight": sd[f"{prefix}.upsample_occ.weight"]}
    if feat_size > 16:
        out["proj"] = _convlayer(sd, f"{prefix}.proj")
    if corr_stride != 1:
        out["upsample_corr"] = {"weight": sd[f"{prefix}.upsample_corr.weight"]}
    for i in range(3):
        out[f"convs{i}"] = _convlayer(sd, f"{prefix}.convs.{i}")
    out["flow_head"] = _convlayer(sd, f"{prefix}.flow_head")
    out["occ_head"] = _convlayer(sd, f"{prefix}.occ_head")
    return out


def _subpixel(sd, prefix):
    out = {f"convs{i}": _convlayer(sd, f"{prefix}.convs.{i}") for i in range(3)}
    out["flow_head"] = _convlayer(sd, f"{prefix}.flow_head")
    out["occ_head"] = _convlayer(sd, f"{prefix}.occ_head")
    return out


def port_decoder(cfg, sd):
    """``qvid_g`` (or ``qvid_gl``) state dict -> the SkipDecoder tree, with
    its ``Matching`` and ``Subpixel`` heads. ``cfg`` is the port's
    ``AutoencoderConfig``: ``Config.from_json`` refuses a config that sets
    ``use_tradeoff``, ``no_corr``, ``no_proj`` or ``use_inter`` off."""
    sd = _arrays(sd)
    n = cfg.num_resolutions
    sched = interblock_schedule(n)
    out = {"block0": _convlayer(sd, "blocks.0")}
    for i in range(1, n):
        out[f"block{i}"] = _resblock(sd, f"blocks.{i}")
    if f"blocks.{n}.0.weight" in sd:
        out[f"block{n}"] = _convlayer(sd, f"blocks.{n}")
    for i in range(n):
        out[f"inter_block{i}"] = {
            "matching": _matching(sd, f"inter_blocks.{i}.matching", cfg.inter_sizes_dec[i],
                                  i == 0, sched[i]["corr_stride"]),
            "subpixel": _subpixel(sd, f"inter_blocks.{i}.subpixel"),
        }
    return out


def port_quantizer(sd):
    """``qvid_q`` / ``qvid_ql`` / ``state_q`` / ``stft_q`` state dict -> the
    VectorQuantizer tree (the codebook)."""
    return {"embedding": _np(sd["embedding.weight"])}


def port_gpt(cfg, sd):
    """``transformer_t`` state dict -> the GPT tree (blocks stacked over
    layers), under any ``emb_mode``, with the state, start-token and label
    embeddings where ``cfg`` has them and the state dict holds them."""
    sd = _arrays(sd)
    n = cfg.n_layer

    def stack(key):
        return np.stack([sd[f"blocks.{i}.{key}"] for i in range(n)])

    def dense(key):
        # Linear weight (out, in) -> Dense kernel (in, out), stacked over layers
        return {"kernel": np.stack([sd[f"blocks.{i}.{key}.weight"].T for i in range(n)]),
                "bias": stack(f"{key}.bias")}

    block = {
        "ln1": {"scale": stack("ln1.weight"), "bias": stack("ln1.bias")},
        "ln2": {"scale": stack("ln2.weight"), "bias": stack("ln2.bias")},
        "attn": {m: dense(f"attn.{m}") for m in ("key", "query", "value", "proj")},
        "fc1": dense("mlp.0"),
        "fc2": dense("mlp.3"),
    }
    out = {
        "tok_emb": {"embedding": sd["tok_emb.weight"]},
        "core": {"blocks": {"block": block},
                 "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]}},
        "head": {"kernel": sd["head.weight"].T},
    }
    pos = {"temporal": ("s_emb", "t_emb"), "spatio-temporal": ("h_emb", "w_emb", "t_emb"),
           None: ("pos_emb",)}[cfg.emb_mode]
    out.update({k: sd[k] for k in pos})
    if cfg.state_num > 0 and cfg.state_size > 0 and "state_tok_emb.weight" in sd:
        out["state_tok_emb"] = {"embedding": sd["state_tok_emb.weight"]}
        key = "state_pos_emb" if cfg.emb_mode is None else "state_s_emb"
        out[key] = sd[key]
    if cfg.use_start_token and "start_tok_emb" in sd:
        out["start_tok_emb"] = sd["start_tok_emb"]
    if cfg.cat and "lbl_emb.weight" in sd:
        out["lbl_emb"] = {"embedding": sd["lbl_emb.weight"]}
    return out


def _d_convlayer(sd, prefix, downsample=False, activate=True):
    """The discriminators' ``ConvLayer`` (``gan.py``): the bias sits in the
    FusedLeakyReLU after the conv when it activates."""
    ci = 1 if downsample else 0
    out = {"conv": {"weight": sd[f"{prefix}.{ci}.weight"]}}
    if activate and f"{prefix}.{ci + 1}.bias" in sd:
        out["act_bias"] = sd[f"{prefix}.{ci + 1}.bias"]
    elif f"{prefix}.{ci}.bias" in sd:
        out["conv"]["bias"] = sd[f"{prefix}.{ci}.bias"]
    return out


def port_image_discriminator(cfg, sd):
    """``qvid_di`` state dict -> the ImageDiscriminator tree."""
    sd = _arrays(sd)
    init_res = int(math.log2(cfg.z_shape[0])) - cfg.downsample_dis_num
    final_res = init_res + len(cfg.ndcf_mult) - 1
    out = {"conv0": _d_convlayer(sd, "convs.0")}
    for i in range(1, final_res - 1):
        out[f"res{i}"] = {
            "conv1": _d_convlayer(sd, f"convs.{i}.conv1"),
            "conv2": _d_convlayer(sd, f"convs.{i}.conv2", downsample=True),
            "skip": _d_convlayer(sd, f"convs.{i}.skip", downsample=True, activate=False),
        }
    out["final_conv"] = _d_convlayer(sd, "final_conv")
    for j in (0, 1):
        out[f"fc{j + 1}"] = {"weight": sd[f"final_linear.{j}.weight"],
                             "bias": sd[f"final_linear.{j}.bias"]}
    return out


def port_state_estimator(cfg, sd):
    """``state_s`` state dict -> the StateEstimator tree."""
    sd = _arrays(sd)
    out = {}
    h, w = cfg.z_shape
    i = 0
    while h > 1 and w > 1:
        out[f"conv{i}"] = _convlayer(sd, f"convs.{i}", downsample=True)
        h, w, i = h // 2, w // 2, i + 1
    out["fc"] = {"weight": sd["fc.weight"], "bias": sd["fc.bias"]}
    return out


def port_stft(cfg, enc_sd, dec_sd):
    """``stft_e`` and ``stft_d`` state dicts -> the STFT autoencoder's
    ``encoder`` and ``decoder`` trees."""
    enc_sd, dec_sd = _arrays(enc_sd), _arrays(dec_sd)
    enc = {f"conv{i}": _convlayer(enc_sd, f"convs.{i}", downsample=(1 <= i <= 3))
           for i in range(5)}
    dec = {f"conv{i}": _convlayer(dec_sd, f"convs.{i}") for i in range(5)}
    return {"encoder": enc, "decoder": dec}


def port_autoencoder(cfg, sds):
    """The ``qvid_{e,q,g}`` state dicts of ``sds`` (label -> state dict) ->
    the FrameAutoencoder tree; the layout twins ride ``qvid_{el,ql,gl}``
    (``quantized_video_model.py:208-223``; with ``same_decoder_layout`` the
    reference saves no ``qvid_gl``)."""
    out = {
        "encoder": port_encoder(cfg, sds["qvid_e"]),
        "quantizer": port_quantizer(sds["qvid_q"]),
        "decoder": port_decoder(cfg, sds["qvid_g"]),
    }
    for label, key, fn in (("qvid_el", "encoder_l", port_encoder),
                           ("qvid_gl", "decoder_l", port_decoder)):
        if label in sds:
            out[key] = fn(cfg, sds[label])
    if "qvid_ql" in sds:
        out["quantizer_l"] = port_quantizer(sds["qvid_ql"])
    return out


# ---------------- checkpoint-transfer transforms ----------------


def apply_block_delta(sd, delta):
    """``blocks.{i}`` / ``inter_blocks.{i}`` renumbered to ``i + delta``
    (``load_state_dict(block_delta=...)``, ``models/__init__.py:28-42``), so
    that a checkpoint of one number of resolutions starts a model of more or
    fewer; keys shifted out of range are left out by the ``port_*``
    functions."""
    out = {}
    for k, v in sd.items():
        m = re.match(r"^(blocks|inter_blocks)\.(\d+)\.(.*)$", k)
        out[f"{m.group(1)}.{int(m.group(2)) + delta}.{m.group(3)}" if m else k] = v
    return out


def apply_head_to_n(sd, n):
    """A 1-proposal CGPT head ``(n_in, D)`` expanded to ``n`` proposals
    (``load_state_dict(head_to_n=...)``, ``models/__init__.py:99-107``): ``n``
    groups of ``[a zero logit row, the n_in value rows]``, the layout
    :class:`ccvs_tpu_torch.nn.gpt.CGPT` reads its head in, so every proposal
    is the 1-proposal prediction and every logit 0. (The JAX package's
    ``apply_head_to_n`` stacks ``[n x values; n zero rows]``, which its own
    ``CGPT`` does not read as copies; ROADMAP.md, "Differences by
    design".)"""
    out = dict(sd)
    w = _np(sd["head.weight"])  # (n_in, D)
    group = np.concatenate([np.zeros((1, w.shape[1]), w.dtype), w], axis=0)
    out["head.weight"] = np.concatenate([group] * n, axis=0)
    return out


def prune_mismatched(sd, target_shapes, verbose=True):
    """Non-strict loading (``models/__init__.py:44-59``): the keys whose
    shapes differ from ``target_shapes`` are dropped."""
    out = {}
    for k, v in sd.items():
        if k in target_shapes and tuple(v.shape) != tuple(target_shapes[k]):
            if verbose:
                print(f"prune {k}: {tuple(v.shape)} != {tuple(target_shapes[k])}")
            continue
        out[k] = v
    return out
