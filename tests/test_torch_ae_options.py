"""The autoencoder's options that no preset sets, in ccvs_tpu_torch against
ccvs_tpu on the CPU in fp32: the decoder's flow-module options (deformable
conv, masked flow, tradeoff features, no correlation, no projection,
skip-RGB with and without ``tanh``, no context fusion, the tiled-x convs),
``deform_conv3x3`` and its gradients, the rollout's ``keep_first`` /
``n_first``, ``skip_mode`` "dec" and ``decode_buckets``, step-by-step
generation with pinned first frames, the G losses under the combined
options, an image G and D step at ``aspect_ratio`` 2, the weights' round
trip into ccvs_tpu, ``port_decoder``'s trees and ``Config.from_json``.

The decoder configuration has four resolutions at 32 px (the finest runs the
stride-2 correlation) and ``inter_p`` 1.0 with multipliers (1, 1, 2, 2), so
that every context width is a multiple of 32, as ``use_tradeoff`` needs.
The JAX side runs under ``jax.jit`` (``fast_jit`` for the losses). Each
test states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.nn import discriminators as jdisc
from ccvs_tpu.nn.decoder import SkipDecoder as JDecoder
from ccvs_tpu.ops.deform import deform_conv3x3 as j_deform_conv3x3
from ccvs_tpu.port import port_pytorch as jpp
from ccvs_tpu.port.npz_params import unflatten_params
from ccvs_tpu.train.ae_losses import AELosses as JLosses
from ccvs_tpu_torch import config as tcfg
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.nn import discriminators as tdisc
from ccvs_tpu_torch.nn.decoder import SkipDecoder
from ccvs_tpu_torch.ops.deform import deform_conv3x3
from ccvs_tpu_torch.port import port_pytorch as tpp
from ccvs_tpu_torch.train.ae_losses import AELosses
from ccvs_tpu_torch.weights import export_params
from test_torch_ae_train import port_tree
from test_torch_port_pytorch import assert_trees_equal, synth_decoder_sd
from test_torch_train import close, largest
from test_train import AE_CFG
from torch_parity import (fast_jit, few_threads, jax_params, load_into, port_config, set_fp32,
                          to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

AE = jcfg.AutoencoderConfig(
    necf=32, necf_mult=(1, 1, 2, 2), z_size=16, z_num=64, z_shape=(4, 4), max_dim=32,
    inter_p=1.0, skip_memory=3, skip_context=(1, 2, 3))
FLOW = dict(use_deformed_conv=True, use_masked_flow=True, use_tradeoff=True)
OPTIONS = {
    "deform": dict(use_deformed_conv=True),
    "masked": dict(use_masked_flow=True),
    "tradeoff": dict(use_tradeoff=True),
    "deform_masked_tradeoff": FLOW,
    "no_corr": dict(no_corr=True),
    "no_corr_tiled_x": dict(no_corr=True, shared_x_split=False),
    "no_proj": dict(no_proj=True),
    "skip_rgb": dict(skip_rgb=True),
    "skip_rgb_tanh": dict(skip_rgb=True, skip_tanh=True),
    "no_inter": dict(use_inter=False),
    "tiled_x": dict(shared_x_split=False),
}
# the 14 fields the port now has, each at a value other than its default
NON_DEFAULT = {
    "aspect_ratio": 2.0, "use_inter": False, "no_corr": True, "no_proj": True,
    "use_masked_flow": True, "use_deformed_conv": True, "use_tradeoff": True,
    "skip_rgb": True, "skip_tanh": True, "skip_mode": "dec", "keep_first": True,
    "n_first": 2, "shared_x_split": False, "decode_buckets": (3,),
}


def he_deform(params, cfg):
    """``params`` with each deformable conv's weight at flax's He scale (the
    seeded draw is N(0, 1), ~7x too wide for a 9 x 64-input conv)."""
    def leaf(path, x):
        if getattr(path[-1], "key", None) == "deform_weight":
            return x * (2.0 / (x.shape[1] * 9)) ** 0.5
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


def smooth_features(rng, batch, h, w, c):
    """``(B, h, w, c)`` channels of random plane waves of 0.5-2 periods a
    frame, amplitude 0.5: spatially smooth, as an encoder's features of
    frames are. On white noise the warps' derivative is of the order of the
    features themselves, and one fp32 rounding of a flow moves the decoded
    frame by ~1e-5 of its largest entry in either package (the JAX
    package's own fp32 lies 9.5e-6 from a float64 decode there)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    fy, fx, phase = (rng.uniform(lo, hi, (batch, 1, 1, c))
                     for lo, hi in ((0.5, 2), (0.5, 2), (0, 2 * np.pi)))
    return (0.5 * np.sin(2 * np.pi * (fy * yy[..., None] + fx * xx[..., None]) + phase)
            ).astype(np.float32)


def ctx_inputs(cfg, batch, k, seed):
    """``z`` ``(B, 4, 4, z_size)``, k smooth contexts (each per resolution,
    finest first) and a partial ``ctx_mask`` ``(B, k)``."""
    rng = np.random.RandomState(seed)
    z = rng.randn(batch, *cfg.z_shape, cfg.z_size).astype(np.float32)
    h, w = cfg.max_dim, int(cfg.max_dim * cfg.aspect_ratio)
    ctx = [[smooth_features(rng, batch, h >> r, w >> r, c)
            for r, c in enumerate(cfg.inter_sizes_enc)] for _ in range(k)]
    mask = np.ones((batch, k), np.float32)
    mask[0, 1] = mask[1, 2] = 0.0
    return z, ctx, mask


@pytest.mark.parametrize("name", list(OPTIONS))
def test_decoder_options_match_ccvs_tpu(name):
    """``SkipDecoder`` under each option set with k = 3 contexts, a partial
    ``ctx_mask`` and ``return_all``: the parameters the JAX package creates
    and no others (loading raises on a missing or extra one), the frame,
    every resolution's flows and occlusion logits and the fused features
    within 1e-5 of each output's largest entry."""
    cfg = dataclasses.replace(AE, **OPTIONS[name])
    jdec = JDecoder(cfg, dtype=F32)
    z, ctx, mask = ctx_inputs(cfg, 2, 3, seed=3)
    jctx = [[jnp.asarray(f) for f in c] for c in ctx]
    params = he_deform(jax_params(lambda key: jdec.init(key, jnp.asarray(z), jctx,
                                                        ctx_mask=jnp.asarray(mask))["params"],
                                  seed=4), cfg)
    want = fast_jit(lambda p, z, c, m: jdec.apply({"params": p}, z, c, ctx_mask=m,
                                                  return_all=True, inter_pre_warping=False))(
        params, jnp.asarray(z), jctx, jnp.asarray(mask))
    tdec = load_into(SkipDecoder(port_config(cfg)), params)
    got = tdec(torch.from_numpy(z),
               SkipDecoder.stack_contexts([[torch.from_numpy(f) for f in c] for c in ctx]),
               ctx_mask=torch.from_numpy(mask), return_all=True, inter_pre_warping=False)
    assert got[1] is None and want[1] is None
    close(got[0], want[0], rtol=1e-5, rel_atol=1e-5, what="rgb")
    for i in (2, 3, 4):
        assert len(got[i]) == len(want[i]) == (0 if name == "no_inter" else 4)
        for g, w in zip(got[i], want[i]):
            close(g, w, rtol=1e-5, rel_atol=1e-5, what=f"output {i}")
    if cfg.skip_tanh:
        assert float(np.abs(np.asarray(want[0])).max()) < 1.0


def test_deform_conv3x3_and_its_gradients_match_ccvs_tpu():
    """``deform_conv3x3`` on a non-square input: the value within 1e-5 of
    its largest entry, and its gradients with respect to the input, the
    offset, the weight and the bias against ``jax.grad`` within 1e-5 of
    each one's largest entry (offsets of up to 3 pixels: some taps sample
    outside the frame)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 7, 10, 4).astype(np.float32)
    flow = (rng.randn(2, 7, 10, 2) * 1.5).astype(np.float32)
    w = (rng.randn(5, 4, 3, 3) * 0.3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    cot = rng.randn(2, 7, 10, 5).astype(np.float32)

    def jf(x, f, w, b):
        return jnp.sum(j_deform_conv3x3(x, f, w, b) * cot)

    want = jax.jit(j_deform_conv3x3)(x, flow, w, b)
    jgrads = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(x, flow, w, b)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, flow, w, b)]
    got = deform_conv3x3(*args)
    close(got, want, rtol=1e-5, rel_atol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), args)
    for name, g, jg in zip(("x", "flow", "weight", "bias"), grads, jgrads):
        close(g, jg, rtol=1e-5, rel_atol=1e-5, what=name)


# the serving tests' greedy setting: two resolutions at 8 px, 16 tokens a
# frame, a 3-slot FIFO
SMALL = jcfg.AutoencoderConfig(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
    max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3))
ROLLOUTS = {
    "keep_first_1": dict(keep_first=True, n_first=1),
    "keep_first_2": dict(keep_first=True, n_first=2),
    "skip_mode_dec": dict(skip_mode="dec"),
    "buckets_3": dict(decode_buckets=(3,)),
}


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_decode_video_options_match_ccvs_tpu(name):
    """``decode_video`` of 7 frames from 1 (the 3-slot FIFO full from the
    fourth frame on): with ``keep_first`` (``n_first`` 1 and 2, pinned for
    the last four frames), with ``skip_mode`` "dec" (the decoder's fused
    features pushed, no re-encode) and with the JAX package's
    ``decode_buckets`` (3,) against the port's exact slot count: every frame
    within 1e-5 of the largest entry. The option changes the frames after
    the FIFO's first pinned push, or after the first generated frame
    (``decode_buckets`` changes none)."""
    cfg = dataclasses.replace(SMALL, **ROLLOUTS[name])
    jae = JAE(cfg, dtype=F32)
    params = jax_params(jae.init, seed=9)
    rng = np.random.RandomState(11)
    codes = rng.randint(0, cfg.z_num, (2, 7, 16)).astype(np.int32)
    ctx = rng.uniform(-1, 1, (2, 1, 8, 8, 3)).astype(np.float32)
    want = fast_jit(lambda p, c, f: jae.decode_video(p, c, f, n_ctx=1))(
        params, jnp.asarray(codes), jnp.asarray(ctx))
    got = {}
    for key, c in (("on", cfg), ("off", SMALL)):
        tae = load_into(FrameAutoencoder(port_config(c), dtype=torch.float32, device="cpu"),
                        params)
        got[key] = tae.decode_video(torch.from_numpy(codes), torch.from_numpy(ctx), n_ctx=1)
    close(got["on"], want, rtol=1e-5, rel_atol=1e-5)
    moved = (got["on"] - got["off"]).abs()
    if name == "buckets_3":
        assert float(moved.max()) == 0.0
    else:
        first = 4 if cfg.keep_first else 2
        assert float(moved[:, :first].max()) == 0.0
        assert float(moved[:, first:].max()) > 1e-3


GPT = jcfg.TransformerConfig(
    z_num=32, z_len=48, z_chunk=16, num_blocks=4, cond_len=16, n_layer=2, n_head=2, n_embd=32,
    z_shape=(4, 4), emb_mode="temporal", top_k=1, top_k_state=1)


def test_step_by_step_with_keep_first_matches_ccvs_tpu():
    """Greedy ``generate_step_by_step`` of 6 frames from 1 with
    ``keep_first`` (``n_first`` 2): the video within 1e-3 of the JAX
    package's and the re-encodes' tokens equal."""
    cfg = dataclasses.replace(SMALL, keep_first=True, n_first=2)
    jae, jtr = JAE(cfg, dtype=F32), JTT(GPT, dtype=F32)
    params = {"ae": jax_params(jae.init, seed=0),
              "gpt": jax_params(lambda k: jtr.init(k, batch=2), seed=20)}
    tae = load_into(FrameAutoencoder(port_config(cfg), dtype=torch.float32, device="cpu"),
                    params["ae"])
    ttr = TokenTransformer(port_config(GPT), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params["gpt"])
    jgen = JGen(jcfg.Config(ae=cfg, gpt=GPT), jae, jtr)
    gen = VideoGenerator(tcfg.Config(ae=tae.cfg, gpt=ttr.cfg), tae, ttr)
    vid = np.random.RandomState(19).uniform(-1, 1, (2, 6, 8, 8, 3)).astype(np.float32)
    want = fast_jit(lambda p, k, v: jgen.generate_step_by_step(p, k, v, n_ctx_frames=1))(
        params, jax.random.PRNGKey(0), jnp.asarray(vid))
    got = gen.generate_step_by_step(torch.from_numpy(vid), torch.Generator().manual_seed(0),
                                    n_ctx_frames=1)
    np.testing.assert_allclose(to_np(got["fake"]), np.asarray(want["fake"]), rtol=1e-3,
                               atol=1e-3)
    reenc = tae.encode(got["fake"])["code"].reshape(2, -1)
    np.testing.assert_array_equal(to_np(got["code"][:, 16:]), to_np(reenc[:, 16:]))


# the AE training tests' configuration, two resolutions of context widths 64
# and 32 (tradeoff), with the combined options
COMBINED = dataclasses.replace(
    AE_CFG, necf=32, inter_p=1.0, use_dv=False, use_elastic_flow_recovery=False,
    skip_rgb=True, skip_tanh=True, **FLOW)


def _models(cfg, h, w):
    ae = JAE(cfg, dtype=F32)
    di = jdisc.ImageDiscriminator(cfg)
    jlosses = JLosses(cfg, ae, di=di)
    gen = he_deform(jax_params(ae.init, seed=1), cfg)
    disc = jax_params(lambda k: {"di": di.init(k, jnp.zeros((2, h, w, 3)))["params"]}, seed=2)
    pcfg = port_config(cfg)
    tae = load_into(FrameAutoencoder(pcfg, dtype=torch.float32, device="cpu"), gen)
    tdi = load_into(torch.nn.ModuleDict({"di": tdisc.ImageDiscriminator(pcfg)}), disc)["di"]
    return jlosses, gen, disc, AELosses(pcfg, tae, di=tdi)


def _img_batch(cfg, h, w, seed):
    rng = np.random.RandomState(seed)
    return {"img": (rng.randn(6, h, w, 3) * 0.3).astype(np.float32),
            "mask_img": (rng.rand(2, h, w, 1) > 0.5).astype(np.float32)}


def _check_g(jlosses, gen, disc, losses, kind, batch):
    fn = jlosses.img_generator_loss if kind == "img" else jlosses.vid_generator_loss
    (jloss, (jm, _)), jgrad = fast_jit(jax.value_and_grad(
        lambda g, b: fn(g, disc, None, b, jax.random.PRNGKey(0)), has_aux=True))(
        gen, {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = losses.img_generator_loss if kind == "img" else losses.vid_generator_loss
    loss, (m, _) = tfn({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == set(jm), set(m) ^ set(jm)
    for k, v in jm.items():
        assert float(m[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-8), k
    params = dict(losses.ae.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    want = port_tree(losses.ae, jgrad)
    scale = largest(want.values())
    for (n, p), g in zip(params.items(), grads):
        close(torch.zeros_like(p) if g is None else g, want[n], rtol=1e-4, rel_atol=1e-4,
              scale=scale, what=n)
    return want


@pytest.mark.parametrize("kind", ["img", "vid"])
def test_generator_losses_under_the_combined_options_match_ccvs_tpu(kind):
    """The image and video G losses with deformable conv, masked flow,
    tradeoff features, skip-RGB and ``tanh`` together: every term within
    rtol 1e-5, every generator gradient within rtol 1e-4 plus 1e-4 of the
    largest entry, the deformable convs' and tradeoff upsamplers' nonzero.
    (The elastic flow term is off: on a binary mask its 0.5 threshold of the
    resized mask decides on rounding; ``tests/test_torch_gpt_variants.py``
    says more.)"""
    h = COMBINED.max_dim
    jlosses, gen, disc, losses = _models(COMBINED, h, h)
    if kind == "img":
        batch = _img_batch(COMBINED, h, h, 12)
    else:
        rng = np.random.RandomState(13)
        batch = {"vid": (rng.randn(2, COMBINED.vid_len, h, h, 3) * 0.3).astype(np.float32)}
    want = _check_g(jlosses, gen, disc, losses, kind, batch)
    for n in ("decoder.inter_block1.matching.deform_weight",
              "decoder.inter_block1.matching.upsample_toff.weight", "decoder.to_rgb1.bias"):
        assert float(want[n].abs().max()) > 0, n


def test_image_g_and_d_steps_at_aspect_ratio_2_match_ccvs_tpu():
    """Frames of 8 x 16 (``aspect_ratio`` 2, ``z_shape`` (4, 8)): the image
    G loss and its gradients as in the combined test, and the image D loss
    with the discriminator's gradients (its ``fc1`` takes ``4 x 8``
    positions) within rtol 1e-5 / 1e-4 plus 1e-4 of the largest."""
    cfg = dataclasses.replace(AE_CFG, aspect_ratio=2.0, z_shape=(4, 8), use_dv=False,
                              use_elastic_flow_recovery=False)
    h, w = cfg.max_dim, 2 * cfg.max_dim
    jlosses, gen, disc, losses = _models(cfg, h, w)
    assert losses.di.fc1.weight.shape[1] == losses.di.final_conv.conv.weight.shape[0] * 4 * 8
    batch = _img_batch(cfg, h, w, 14)
    _check_g(jlosses, gen, disc, losses, "img", batch)
    fake = np.random.RandomState(15).randn(4, h, w, 3).astype(np.float32) * 0.3
    real = batch["img"]
    (jd, (jm, _)), jgrad = jax.jit(jax.value_and_grad(
        lambda d: jlosses.img_discriminator_loss(d, jnp.asarray(real), jnp.asarray(fake)),
        has_aux=True))(disc)
    di = losses.di
    loss, (m, _) = losses.img_discriminator_loss(torch.from_numpy(real), torch.from_numpy(fake))
    assert float(loss) == pytest.approx(float(jd), rel=1e-5)
    params = dict(di.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    want = port_tree(torch.nn.ModuleDict({"di": di}), jgrad)
    scale = largest(want.values())
    for (n, _), g in zip(params.items(), grads):
        close(g, want["di." + n], rtol=1e-4, rel_atol=1e-4, scale=scale, what=n)


def tree_shapes(tree, prefix=""):
    """``{"a/b/c": shape}`` of a (shape-only) parameter tree."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(tree_shapes(v, key) if hasattr(v, "items") else {key: tuple(v.shape)})
    return out


@pytest.mark.parametrize("name", ["deform_masked_tradeoff_skip_rgb", "no_inter", "no_corr"])
def test_weights_round_trip_into_ccvs_tpu(name):
    """The port's autoencoder with the options, seeded, exported with
    ``export_params``: the JAX package's parameter tree (``deform_weight``,
    ``deform_bias``, ``upsample_toff``, ``to_rgb{i}``; no ``inter_block*``
    without context fusion), each array equal, and loaded back into the
    port."""
    over = {"deform_masked_tradeoff_skip_rgb": dict(skip_rgb=True, **FLOW),
            "no_inter": dict(use_inter=False), "no_corr": dict(no_corr=True)}[name]
    cfg = dataclasses.replace(AE, **over)
    tae = FrameAutoencoder(port_config(cfg), dtype=torch.float32, device="cpu").init(seed=3)
    flat = export_params(tae)
    shapes = jax.eval_shape(JAE(cfg, dtype=F32).init, jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in flat.items()} == tree_shapes(shapes)
    tree = unflatten_params(flat)
    back = load_into(FrameAutoencoder(port_config(cfg), dtype=torch.float32, device="cpu"), tree)
    for (n, p), (_, q) in zip(tae.named_parameters(), back.named_parameters()):
        assert torch.equal(p, q), n
    keys = " ".join(flat)
    assert ("inter_block" in keys) == cfg.use_inter
    assert ("deform_weight" in keys) == cfg.use_deformed_conv
    assert ("to_rgb3" in keys) == cfg.skip_rgb


@pytest.mark.parametrize("name", ["tradeoff", "no_corr", "no_proj", "no_inter"])
def test_port_decoder_trees_match_ccvs_tpu(name):
    """``port_decoder`` under ``use_tradeoff``, ``no_corr``, ``no_proj`` and
    ``use_inter`` off gives the JAX package's tree, bit-equal, from a
    reference-keyed state dict built for that configuration."""
    cfg = dataclasses.replace(AE, **OPTIONS[name])
    rng = np.random.RandomState(6)
    sd = synth_decoder_sd(cfg, rng)
    for i in range(1, cfg.num_resolutions):
        s = cfg.inter_sizes_dec[i]
        sd[f"inter_blocks.{i}.matching.upsample_toff.weight"] = (
            rng.randn(32, s // 32, 4, 4).astype(np.float32))
    assert_trees_equal(tpp.port_decoder(port_config(cfg), sd), jpp.port_decoder(cfg, sd))


@pytest.mark.parametrize("name", list(NON_DEFAULT))
def test_config_loads_each_option_off_its_default(name):
    """``Config.from_json`` of a JAX config with one of the 14 options off
    its default keeps the value (the tradeoff case on widths it accepts)."""
    ae = dataclasses.replace(AE, **{name: NON_DEFAULT[name]})
    got = tcfg.Config.from_json(jcfg.Config(ae=ae).to_json())
    assert getattr(got.ae, name) == NON_DEFAULT[name]
    assert got.ae == port_config(ae)


def test_tradeoff_needs_context_widths_of_32():
    """``use_tradeoff`` with a context width that is no multiple of 32 (the
    tradeoff upsampler has 32 groups) raises in the port's config, where
    the JAX package would fail later, inside flax."""
    with pytest.raises(ValueError, match="multiple of 32"):
        tcfg.AutoencoderConfig(necf=16, necf_mult=(1, 2), inter_p=0.75, use_tradeoff=True)
    bad = dataclasses.replace(AE, inter_p=0.75, use_tradeoff=True)
    with pytest.raises(ValueError, match="multiple of 32"):
        tcfg.Config.from_json(jcfg.Config(ae=bad).to_json())
    assert tcfg.AutoencoderConfig(necf=32, necf_mult=(1, 2), inter_p=1.0, use_tradeoff=True)
