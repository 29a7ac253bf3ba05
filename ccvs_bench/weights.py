"""Seeded weights, made on the device in one draw a model, and the leaf
lists they fill.

Every leaf is listed from the configuration's sizes alone (:func:`ae_leaves`,
:func:`gpt_leaves`), keyed as the program's ``state_dict`` keys, so that a
strict load into the program checks that it holds exactly these leaves.
Values are drawn as one normal vector, scaled leaf by leaf, and rounded once
to bf16: every value is exact in bf16 and in fp32, so the program (bf16 or
fp32 parameters) and the fp32 reference start from the same numbers.
Biases, positional embeddings and LayerNorm shifts are drawn too (the
program's own init zeroes them), so that every path of the model carries
signal.
"""

import numpy as np
import torch

from ccvs_bench.reference import ae as ref_ae
from ccvs_bench.reference.precision import exact, fp32_mode


def sub_seed(seed, *tags):
    """A 63-bit seed of its own for each ``tags`` under the run's ``seed``."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0]) >> 1


def generator(device, seed, *tags):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _conv(leaves, name, cout, cin, k, bias=True):
    leaves.append((f"{name}.conv.weight", (cout, cin, k, k), 1.0, 0.0))
    if bias:
        leaves.append((f"{name}.conv.bias", (cout,), 0.1, 0.0))


def _res(leaves, name, cin, cout):
    _conv(leaves, f"{name}.conv1", cin, cin, 3)
    _conv(leaves, f"{name}.conv2", cout, cin, 3)
    _conv(leaves, f"{name}.skip", cout, cin, 1, bias=False)


def _flow_convs(leaves, name, cin, kernel):
    _conv(leaves, f"{name}.convs0", 128, cin, 3)
    _conv(leaves, f"{name}.convs1", 64, 128, 3)
    _conv(leaves, f"{name}.convs2", 32, 64, 3)
    _conv(leaves, f"{name}.flow_head", 2, 32, kernel)
    _conv(leaves, f"{name}.occ_head", 1, 32, kernel)


def ae_leaves(ae):
    """``(name, shape, std, mean)`` of every leaf of the frame autoencoder
    but the codebook: equalised conv weights N(0, 1), their biases N(0,
    0.1), grouped upsamplers N(0, 0.02)."""
    ref_ae.check_supported(ae)
    nres = len(ae["necf_mult"])
    enc, dec = ref_ae.enc_channels(ae), ref_ae.dec_channels(ae)
    leaves = []
    _conv(leaves, "encoder.block0", enc[0], 3, 1)
    for i in range(1, nres):
        _res(leaves, f"encoder.block{i}", enc[i - 1], enc[i])
    _conv(leaves, f"encoder.block{nres}", ae["z_size"], enc[-1], 1)
    _conv(leaves, "decoder.block0", dec[0], ae["z_size"], 1)
    for i, (fs, (kernel, _, stride)) in enumerate(zip(ref_ae.inter_sizes_dec(ae),
                                                       ref_ae.schedule(nres))):
        if i > 0:
            _res(leaves, f"decoder.block{i}", dec[i - 1], dec[i])
        name = f"decoder.inter_block{i}"
        if i > 0:
            leaves += [(f"{name}.matching.upsample_flow.weight", (2, 1, 4, 4), 0.02, 0.0),
                       (f"{name}.matching.upsample_occ.weight", (1, 1, 4, 4), 0.02, 0.0)]
        if fs > 16:
            _conv(leaves, f"{name}.matching.proj", max(16, fs // 4), fs, 1)
        if stride != 1:
            leaves.append((f"{name}.matching.upsample_corr.weight", (49, 1, 4, 4), 0.02, 0.0))
        _flow_convs(leaves, f"{name}.matching", 49, kernel)
        _flow_convs(leaves, f"{name}.subpixel", 2 * fs + 3, kernel)
    _conv(leaves, f"decoder.block{nres}", 3, dec[-1], 1)
    return leaves


def gpt_leaves(gpt):
    """``(name, shape, std, mean)`` of every leaf of the GPT: N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.02)."""
    d, v = gpt["n_embd"], max(gpt["z_num"], gpt.get("state_num", 0))
    size = gpt["z_shape"][0] * gpt["z_shape"][1]
    leaves = [("tok_emb.weight", (gpt["z_num"], d), 0.02, 0.0),
              ("s_emb", (1, size, d), 0.02, 0.0), ("t_emb", (1, gpt["num_blocks"], d), 0.02, 0.0)]
    for i in range(gpt["n_layer"]):
        b = f"core.blocks.{i}"
        for ln in ("ln1", "ln2"):
            leaves += [(f"{b}.{ln}.weight", (d,), 0.02, 1.0), (f"{b}.{ln}.bias", (d,), 0.02, 0.0)]
        for lin in ("query", "key", "value", "proj"):
            leaves += [(f"{b}.attn.{lin}.weight", (d, d), 0.02, 0.0),
                       (f"{b}.attn.{lin}.bias", (d,), 0.02, 0.0)]
        leaves += [(f"{b}.fc1.weight", (4 * d, d), 0.02, 0.0),
                   (f"{b}.fc1.bias", (4 * d,), 0.02, 0.0),
                   (f"{b}.fc2.weight", (d, 4 * d), 0.02, 0.0), (f"{b}.fc2.bias", (d,), 0.02, 0.0)]
    leaves += [("core.ln_f.weight", (d,), 0.02, 1.0), ("core.ln_f.bias", (d,), 0.02, 0.0),
               ("head.weight", (v, d), 0.02, 0.0)]
    return leaves


@torch.no_grad()
def draw(leaves, gen, device):
    """One normal draw for all ``leaves``, scaled and shifted leaf by leaf in
    fp32, then rounded to bf16 in one cast: ``{name: bf16 view}``."""
    total = sum(int(np.prod(shape)) for _, shape, _, _ in leaves)
    buf = torch.randn(total, generator=gen, device=device)
    at, spans = 0, []
    for name, shape, std, mean in leaves:
        n = int(np.prod(shape))
        buf[at:at + n].mul_(std).add_(mean)
        spans.append((name, shape, at, n))
        at += n
    buf = buf.to(torch.bfloat16)
    return {name: buf[a:a + n].view(shape) for name, shape, a, n in spans}


def smooth_clips(gen, shape, device, coarse=16):
    """Clips ``(B, T, H, W, 3)`` in [-1, 1], contiguous in that layout as a
    data loader hands them over (the program's convolutions pick their
    kernels by the memory layout): a coarse normal grid of ``H / coarse``
    cells a side, drawn per frame and upsampled bilinearly, squashed by tanh;
    each clip and frame differs."""
    b, t, h, w, c = shape
    low = torch.randn(b * t, c, max(1, h // coarse), max(1, w // coarse), generator=gen,
                      device=device)
    x = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return torch.tanh(x).permute(0, 2, 3, 1).reshape(b, t, h, w, c).contiguous()


@torch.no_grad()
def codebook_from_latents(p, ae, gen, device):
    """The codebook: the reference encoder's fp32 latents of seeded frames,
    one code a latent position (a trained codebook lies on the latents, and
    seeded random codes would leave the search nearly one code), bf16."""
    n, (hz, wz) = ae["z_num"], ae["z_shape"]
    frames = -(-n // (hz * wz))
    clips = smooth_clips(gen, (1, frames, ae["max_dim"], ae["max_dim"], 3), device)[0]
    pf = {k: v.float() for k, v in p.items()}
    zs = []
    with fp32_mode():
        for chunk in clips.permute(0, 3, 1, 2).split(16):
            z, _ = ref_ae.encode(pf, ae, chunk, exact)
            zs.append(z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]))
    return torch.cat(zs)[:n].to(torch.bfloat16)


def make_ae(ae, seed, device):
    """All leaves of the autoencoder, codebook included, from ``seed``."""
    p = draw(ae_leaves(ae), generator(device, seed, 1), device)
    p["quantizer.embedding"] = codebook_from_latents(p, ae, generator(device, seed, 2), device)
    return p


def make_gpt(gpt, seed, device):
    return draw(gpt_leaves(gpt), generator(device, seed, 3), device)
