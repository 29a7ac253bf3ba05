"""Plain reference of the CCVS frame autoencoder: the SkipGAN encoder, the
nearest-code search, the flow-warping decoder (InterBlock = Matching's cost
volume + Subpixel refinement + an occlusion-weighted average of the warped
contexts) and the doubly-autoregressive rollout decode whose context FIFO
holds the re-encoded frames.

A frozen copy written from the architecture (16lemoing/ccvs
``models/frame_autoencoder``), in plain PyTorch on NCHW tensors. It imports
nothing of the program under test: it reads a flat dict of parameters keyed
as the program's ``state_dict`` keys, made by the benchmark from the seed,
and the benchmark's inputs. Every product goes through ``q`` (operand
rounding: the identity for the fp32 reference, fp8 for the control), and
runs in fp32 with TF32 off (``reference.precision.fp32_mode``).

Only the options of the benchmark's configurations are written here
(``use_inter`` on, ``skip_mode`` "enc", no masked flow, deformable conv,
tradeoff, ``no_corr``, ``no_proj``, skip-RGB, ``z_mult``, layouts or
``keep_first``); :func:`check_supported` refuses any other.
"""

import math

import torch
import torch.nn.functional as F

UNSUPPORTED_TRUE = ("use_masked_flow", "use_deformed_conv", "use_tradeoff", "no_corr", "no_proj",
                    "skip_rgb", "skip_tanh", "keep_first", "normalize_out", "use_layout",
                    "is_continuous")


def check_supported(ae):
    """Raise unless ``ae`` (a configuration's ``ae`` dict) is one this reference computes."""
    bad = [k for k in UNSUPPORTED_TRUE if ae.get(k)]
    if bad or ae.get("skip_mode", "enc") != "enc" or ae.get("z_mult", 1) != 1 \
            or not ae.get("use_inter", True) or ae.get("aspect_ratio", 1.0) != 1.0:
        raise NotImplementedError(f"the reference autoencoder has no option {bad or ae}")


def enc_channels(ae):
    return [ae["necf"] * m for m in ae["necf_mult"]]


def dec_channels(ae):
    return [ae["necf"] * m for m in reversed(ae["necf_mult"])]


def inter_sizes_enc(ae):
    return [int(ae["inter_p"] * c) for c in enc_channels(ae)]


def inter_sizes_dec(ae):
    return [int(ae["inter_p"] * c) for c in dec_channels(ae)]


def schedule(nres):
    """Per decoder resolution, coarsest first: (flow kernel, flow multiplier,
    correlation stride)."""
    return [(2 ** (i // 2 + 1) + 1, float(2 ** i), 2 if i > 2 else 1) for i in range(nres)]


# ---------------------------------------------------------------- primitives

def _blur(x, pad, gain, q):
    """StyleGAN2's FIR blur: pad by ``pad`` (before, after) on both axes, then
    a depthwise 4x4 convolution with the normalised [1, 3, 3, 1] kernel times
    ``gain``."""
    k1 = torch.tensor([1.0, 3.0, 3.0, 1.0], device=x.device)
    k = torch.outer(k1, k1)
    k = (k / k.sum() * gain).flip(0, 1)
    c = x.shape[1]
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(q(x), q(k[None, None].expand(c, 1, 4, 4)), groups=c)


def _conv(p, name, x, q, stride=1, padding=0, transpose=False, bias=True):
    """Equalised conv: the weight ``(O, I, k, k)`` times ``1 / sqrt(I k^2)``;
    transposed, the same weight read as ``(I, O, k, k)``."""
    w = p[name + ".weight"]
    w = w * (1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3]))
    b = p[name + ".bias"] if bias else None
    if transpose:
        return F.conv_transpose2d(q(x), q(w.transpose(0, 1)), b, stride=stride)
    return F.conv2d(q(x), q(w), b, stride=stride, padding=padding)


def conv_layer(p, name, x, q, k, down=False, up=False, act=True, bias=True):
    """[blur] -> equalised conv -> [blur] -> leaky ReLU(0.1)."""
    if down:
        pd = 2 + (k - 1)
        x = _blur(x, ((pd + 1) // 2, pd // 2), 1.0, q)
        x = _conv(p, name + ".conv", x, q, stride=2, bias=bias)
    elif up:
        x = _conv(p, name + ".conv", x, q, stride=2, transpose=True, bias=bias)
        pu = 2 - (k - 1)
        x = _blur(x, ((pu + 1) // 2 + 1, pu // 2 + 1), 4.0, q)
    else:
        x = _conv(p, name + ".conv", x, q, padding=k // 2, bias=bias)
    return F.leaky_relu(x, 0.1) if act else x


def res_block(p, name, x, q, down=False, up=False):
    out = conv_layer(p, name + ".conv2", conv_layer(p, name + ".conv1", x, q, 3), q, 3,
                     down=down, up=up)
    skip = conv_layer(p, name + ".skip", x, q, 1, down=down, up=up, act=False, bias=False)
    return (out + skip) * (1.0 / math.sqrt(2.0))


def grouped_up(p, name, x, q):
    """Grouped 2x transposed conv (k 4, stride 2, padding 1, one group a channel)."""
    w = p[name + ".weight"]
    return F.conv_transpose2d(q(x), q(w), None, stride=2, padding=1, groups=w.shape[0])


def backwarp(x, flow):
    """Bilinear backward warp of ``x`` ``(N, C, H, W)`` along ``flow`` ``(N, 2,
    H, W)`` in pixels (x first), zeros outside, pixel-centre grid;
    flow-x normalised by ``(W - 1) / 2``, flow-y by ``(H - 1) / 2``."""
    _, _, h, w = x.shape
    xs = torch.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w, device=x.device)
    ys = torch.linspace(-1.0 + 1.0 / h, 1.0 - 1.0 / h, h, device=x.device)
    gx = xs[None, None, :] + flow[:, 0] / ((w - 1) / 2.0)
    gy = ys[None, :, None] + flow[:, 1] / ((h - 1) / 2.0)
    return F.grid_sample(x, torch.stack([gx, gy], dim=-1), mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def correlation(a, b, q):
    """7x7 local cost volume at stride 1: ``out[:, (dy+3)*7 + dx+3] = mean_c
    a * shift(b, dy, dx)``, zeros outside ``b``."""
    _, c, h, w = a.shape
    a, bp = q(a), F.pad(q(b), (3, 3, 3, 3))
    vols = [(a * bp[:, :, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]).sum(1) / c
            for dy in range(-3, 4) for dx in range(-3, 4)]
    return torch.stack(vols, dim=1)


# ---------------------------------------------------------------- encoder

def encode(p, ae, x, q, prefix="encoder"):
    """Frames ``(N, 3, H, W)`` -> the latent ``(N, z, h, w)`` and the context
    features of every resolution, finest first (the first ``inter_p`` of its
    channels)."""
    nres, sizes = len(ae["necf_mult"]), inter_sizes_enc(ae)
    out = conv_layer(p, f"{prefix}.block0", x, q, 1)
    inters = [out[:, :sizes[0]]]
    for i in range(1, nres):
        out = res_block(p, f"{prefix}.block{i}", out, q, down=True)
        inters.append(out[:, :sizes[i]])
    return conv_layer(p, f"{prefix}.block{nres}", out, q, 1), inters


def code_distances(z, codebook, q):
    """Squared distances ``(N, K)`` from latents ``(N, D)`` to the codes, up to
    the ``||z||^2`` every code shares: ``||e||^2 - 2 z . e``."""
    return (codebook * codebook).sum(1)[None] - 2.0 * (q(z) @ q(codebook).T)


def nearest_codes(z, codebook, q):
    """Indices of the nearest code of every latent, first index on ties."""
    return code_distances(z, codebook, q).argmin(1)


# ---------------------------------------------------------------- decoder

def _tile(x, k):
    return x.repeat_interleave(k, dim=0)


def matching(p, name, x, k, inter, flow, occ, sch, q):
    """Flow and occlusion logits from the cost volume between the shared
    decoder features ``x`` and each context, refining the coarser block's."""
    kernel, fm, s = sch
    if flow is not None:
        flow = grouped_up(p, name + ".upsample_flow", flow, q)
        occ = grouped_up(p, name + ".upsample_occ", occ, q)
        inter = backwarp(inter, flow * fm)
    xc, ic = x[:, :, ::s, ::s], inter[:, :, ::s, ::s]
    if x.shape[1] > 16:  # a 1x1 projection to a quarter of the channels (at least 16)
        xc, ic = conv_layer(p, name + ".proj", xc, q, 1), conv_layer(p, name + ".proj", ic, q, 1)
    px, pi = _tile(xc, k), ic
    corr = F.leaky_relu(correlation(px, pi, q), 0.1)
    if s != 1:
        corr = grouped_up(p, name + ".upsample_corr", corr, q)
    feat = conv_layer(p, name + ".convs0", corr, q, 3)
    feat = conv_layer(p, name + ".convs2", conv_layer(p, name + ".convs1", feat, q, 3), q, 3)
    dflow = conv_layer(p, name + ".flow_head", feat, q, kernel, act=False)
    docc = conv_layer(p, name + ".occ_head", feat, q, kernel, act=False)
    return (dflow, docc) if flow is None else (flow + dflow, occ + docc)


def subpixel(p, name, x, k, inter, flow, occ, sch, q):
    kernel, fm, _ = sch
    warped = backwarp(inter, flow * fm)
    feat = conv_layer(p, name + ".convs0", torch.cat([_tile(x, k), warped, flow, occ], 1), q, 3)
    feat = conv_layer(p, name + ".convs2", conv_layer(p, name + ".convs1", feat, q, 3), q, 3)
    return (flow + conv_layer(p, name + ".flow_head", feat, q, kernel, act=False),
            occ + conv_layer(p, name + ".occ_head", feat, q, kernel, act=False))


def inter_block(p, name, x, ctx, flow, occ, mask, sch, q, eps=1e-6):
    """Fuse the contexts ``ctx`` ``(B, k, c, h, w)`` into ``x`` ``(B, c, h, w)``:
    each warped along its flow, averaged with weights ``1 - sigmoid(occ)``
    over the valid slots of ``mask`` ``(B, k)``, then blended with ``x`` by
    the sigmoid of the averaged occlusion."""
    b, k = ctx.shape[:2]
    _, c, h, w = x.shape
    inter = ctx.reshape(b * k, c, h, w)
    flow, occ = matching(p, name + ".matching", x, k, inter, flow, occ, sch, q)
    flow, occ = subpixel(p, name + ".subpixel", x, k, inter, flow, occ, sch, q)
    warped = backwarp(inter, flow * sch[1]).reshape(b, k, c, h, w)
    conf = ((1.0 - torch.sigmoid(occ)) + eps).reshape(b, k, 1, h, w)
    if mask is not None:
        conf = conf * mask[:, :, None, None, None]
    denom = conf.sum(1).clamp_min(1e-20)
    warped_avg = (warped * conf).sum(1) / denom
    occ_mask = torch.sigmoid((occ.reshape(b, k, 1, h, w) * conf).sum(1) / denom)
    fused = occ_mask * x + (1.0 - occ_mask) * warped_avg
    if mask is not None:
        fused = torch.where((mask.sum(1) > 0)[:, None, None, None], fused, x)
    return fused, flow, occ


def decode(p, ae, z, ctx, mask, q):
    """Latents ``(B, z, h, w)`` and contexts (per resolution, finest first,
    ``(B, k, c, h, w)``) with slot validity ``mask`` ``(B, k)`` or None ->
    frames ``(B, 3, H, W)``."""
    nres, sizes = len(ae["necf_mult"]), inter_sizes_dec(ae)
    sched = schedule(nres)
    out = conv_layer(p, "decoder.block0", z, q, 1)
    flow = occ = None
    for i in range(nres):
        if i > 0:
            out = res_block(p, f"decoder.block{i}", out, q, up=True)
        fused, flow, occ = inter_block(p, f"decoder.inter_block{i}", out[:, :sizes[i]],
                                       ctx[nres - 1 - i], flow, occ, mask, sched[i], q)
        out = torch.cat([fused, out[:, sizes[i]:]], 1)
    return conv_layer(p, f"decoder.block{nres}", out, q, 1, act=False)


def decode_video(p, ae, codes, ctx_frame, q):
    """The rollout decode of one context frame: ``codes`` ``(B, T, h*w)``
    (the context frame's first), ``ctx_frame`` ``(B, 3, H, W)``. The context
    frame decodes against its own encoder features; each later frame against
    the FIFO of the features of the re-encoded frames before it (at most
    ``skip_memory``, every slot valid), and is re-encoded into the FIFO.
    Returns ``(B, T, 3, H, W)``."""
    b, t = codes.shape[:2]
    hz, wz = ae["z_shape"]
    m = ae["skip_memory"]
    if sorted(ae["skip_context"]) != list(range(1, m + 1)):
        raise NotImplementedError("the reference rollout takes every FIFO slot as context")
    cb = p["quantizer.embedding"]
    z = cb[codes].reshape(b, t, hz, wz, -1).permute(0, 1, 4, 2, 3)
    fifo = [f[:, None] for f in encode(p, ae, ctx_frame, q)[1]]
    frames = [decode(p, ae, z[:, 0], fifo, None, q)]
    for curr in range(1, t):
        rgb = decode(p, ae, z[:, curr], fifo, torch.ones(b, fifo[0].shape[1],
                                                         device=z.device), q)
        frames.append(rgb)
        new = encode(p, ae, rgb, q)[1]
        fifo = [torch.cat([f[:, -(m - 1):], n[:, None]], 1) for f, n in zip(fifo, new)]
    return torch.stack(frames, 1)
