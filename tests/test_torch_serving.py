"""The rest of serving in ccvs_tpu_torch against ccvs_tpu, on the CPU in fp32:
the STFT audio autoencoder and audio-conditioned generation (within one
window and with an audio stream longer than it), class labels, deblurring
with ``blur_video``, the ``down_size`` resize, beam search, the fixed-window
chunk, step-by-step generation (fixed and growing shape, and point to point)
and generation from one image.

Sampling is greedy in both packages (``top_k=1``, or a greedy beam with
``top_k`` >= the beam), so the two random streams never matter. The JAX side
runs its jitted programs on seeded fp32 parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import StftModel as JStftModel
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.train.transformer_trainer import blur_video as j_blur_video
from ccvs_tpu_torch.config import Config, DataConfig
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, StftModel, TokenTransformer
from ccvs_tpu_torch.ops.resize import resize_frames
from ccvs_tpu_torch.train.transformer_trainer import blur_video
from torch_parity import (fast_jit, few_threads, jax_params, load_into, port_config, set_fp32,
                          to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

# two resolutions at 8x8 px (the cheapest autoencoder with the whole decode),
# 16 tokens a frame
AE = jcfg.AutoencoderConfig(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
    max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3), serve_fused=True)
BASE = jcfg.TransformerConfig(
    z_num=32, z_len=48, z_chunk=16, num_blocks=4, cond_len=16, n_layer=2, n_head=2, n_embd=32,
    z_shape=(4, 4), emb_mode="temporal", top_k=1, top_k_state=1)
# a frame's 16 tokens after its 16 audio (or blurred-frame) tokens, 4 frames a window
STREAM = dict(z_len=128, z_chunk=32, state_num=32, state_size=16)
GPTS = {
    "frame": BASE,
    "stft": dataclasses.replace(BASE, stft=True, **STREAM),
    "deblur": dataclasses.replace(BASE, deblurring=True, blur_sigma=2, **STREAM),
    "cat": dataclasses.replace(BASE, cat=True, num_lbl=5),
    "p2p": dataclasses.replace(BASE, p2p=True),
    # the greedy beams of tests/test_generate.py's beam tests
    "beam": dataclasses.replace(BASE, z_len=64, top_k=5, beam_size=3, sample=False,
                                no_sample=True),
    "beam_state": dataclasses.replace(
        BASE, z_len=72, z_chunk=18, cond_len=18, top_k=5, beam_size=2, state=True, state_num=16,
        state_size=2, top_k_state=4, sample=False, sample_state=False, no_sample=True),
}
STFT = jcfg.StftConfig(stft_size=16, stft_shape=(8, 2), stft_hsize=8, stft_num=32)


@pytest.fixture(scope="module")
def gpts():
    """Per mode: the JAX transformer, its seeded params and the port's
    transformer holding them."""
    out = {}
    for i, (name, cfg) in enumerate(GPTS.items()):
        jtr = JTT(cfg, dtype=F32)
        params = jax_params(lambda k: jtr.init(k, batch=2), seed=20 + i)
        ttr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
        load_into(ttr.model, params)
        out[name] = (jtr, params, ttr)
    return out


@pytest.fixture(scope="module")
def aes():
    jae = JAE(AE, dtype=F32)
    params = jax_params(jae.init, seed=0)
    tae = load_into(FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"), params)
    return jae, params, tae


def spectrogram(t, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (2, t, 64, 16, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def stft_models():
    """The STFT model's seeded params, its codebook drawn from encoded
    latents (a seeded one far from them would map every patch to one code).
    The encoder's biases are 0, as flax initializes them: seeded ones give
    the latents an offset five times their spread, and the nearest codes
    then lie within fp32 rounding of each other."""
    jsm = JStftModel(STFT)
    params = jax_params(jsm.init, seed=5)
    params["encoder"] = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.zeros_like(x) if path[-1].key == "bias" else x, params["encoder"])
    lat = np.asarray(fast_jit(lambda p, x: jsm.encoder.apply({"params": p}, x))(
        params["encoder"], jnp.asarray(spectrogram(8, 6)))).reshape(-1, STFT.stft_size)
    pick = np.random.RandomState(7).choice(len(lat), STFT.stft_num, replace=False)
    params["quantizer"]["embedding"] = jnp.asarray(lat[pick])
    tsm = load_into(StftModel(port_config(STFT), device="cpu"), params)
    return jsm, params, tsm


def clip(t, seed=8):
    return np.random.RandomState(seed).uniform(-1, 1, (2, t, 8, 8, 3)).astype(np.float32)


def generators(gpts, aes, mode, stft_models=None):
    """The two packages' VideoGenerators of ``mode`` and the JAX params."""
    jtr, gparams, ttr = gpts[mode]
    jae, aparams, tae = aes
    params = {"ae": aparams, "gpt": gparams}
    jsm = tsm = None
    if stft_models is not None:
        jsm, params["stft"], tsm = stft_models
    jgen = JGen(jcfg.Config(ae=AE, gpt=jtr.cfg, stft=STFT), jae, jtr, stft_model=jsm)
    gen = VideoGenerator(Config(ae=tae.cfg, gpt=ttr.cfg, stft=port_config(STFT)), tae, ttr,
                         stft_model=tsm)
    return jgen, params, gen


def jitted(fn, *args, **static):
    """``fn(*args, **static)`` of the JAX package under one ``jax.jit``
    (``fast_jit``: XLA's quick compile options): its eager glue compiles op
    by op, which costs more on the CPU."""
    return fast_jit(lambda *a: fn(*a, **static))(*args)


def generate_with_tokens(jgen, *args, **kw):
    """The JAX package's ``generate`` and the tokens its transformer made."""
    made = []
    tr_generate = jgen.transformer.generate
    jgen.transformer.generate = lambda *a, **k: made.append(tr_generate(*a, **k)) or made[-1]
    try:
        out = jgen.generate(*args, **kw)
    finally:
        del jgen.transformer.generate
    (tokens,) = made
    return out, tokens


def assert_video_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-3, atol=1e-3)


# ---------------- STFT ----------------


def test_stft_model_matches_ccvs_tpu(stft_models):
    """Encoder latents and decoder output within 1e-5, audio tokens equal,
    ``encode`` / ``decode`` of the model as the JAX package's."""
    jsm, params, tsm = stft_models
    spec = spectrogram(3, 9)
    lat = fast_jit(lambda p, x: jsm.encoder.apply({"params": p}, x))(params["encoder"],
                                                                     jnp.asarray(spec))
    got_lat = tsm.encoder(torch.from_numpy(spec))
    assert got_lat.shape == (2, 3, 8, 2, 16)
    np.testing.assert_allclose(to_np(got_lat), np.asarray(lat), rtol=1e-5, atol=1e-5)
    want_code = np.asarray(fast_jit(jsm.encode)(params, jnp.asarray(spec)))
    got_code = tsm.encode(torch.from_numpy(spec))
    assert want_code.shape == (2, 48)
    np.testing.assert_array_equal(to_np(got_code), want_code)
    assert len(np.unique(want_code)) > 8  # the codebook spans the latents
    want_rec = np.asarray(fast_jit(jsm.decode)(params, jnp.asarray(want_code)))
    got_rec = tsm.decode(got_code)
    assert got_rec.shape == (2, 3, 64, 16, 1)
    np.testing.assert_allclose(to_np(got_rec), want_rec, rtol=1e-5, atol=1e-5)
    dec = fast_jit(lambda p, z: jsm.decoder.apply({"params": p}, z))(params["decoder"], lat)
    np.testing.assert_allclose(to_np(tsm.decoder(got_lat)), np.asarray(dec), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t", [4, 7], ids=["one_window", "stream_longer_than_window"])
def test_stft_generation_matches_ccvs_tpu(gpts, aes, stft_models, t):
    """Audio-conditioned ``generate``: the audio tokens are the whole given
    stream and come back unaltered; frame tokens equal, the video within
    1e-3. With 7 frames the 112 audio tokens outrun the window's 64 state
    slots and the window slides 3 times."""
    jgen, params, gen = generators(gpts, aes, "stft", stft_models)
    vid, spec = clip(t), spectrogram(t, 10)
    want, tokens = generate_with_tokens(jgen, params, jax.random.PRNGKey(0), jnp.asarray(vid),
                                        stft=jnp.asarray(spec), rec=False, n_ctx_frames=1)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0),
                       stft=torch.from_numpy(spec), rec=False, n_ctx_frames=1)
    audio = to_np(stft_models[2].encode(torch.from_numpy(spec)))
    np.testing.assert_array_equal(to_np(got["state_code"]), audio)
    np.testing.assert_array_equal(np.asarray(tokens["state_code"]), audio)
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(tokens["code"]))
    assert_video_close(got["fake"], want["fake"])
    assert "fake_state" not in got and "state" not in got


def test_one_flat_dict_loads_every_model(gpts, aes, stft_models):
    """One flat ``{"a/b/c": array}`` of a whole serving set (the JAX
    package's ``flatten_params`` of ``ae``, ``gpt`` with ``lbl_emb``, and
    ``stft``) loads into the port's models by prefix, every parameter equal."""
    from ccvs_tpu.port.npz_params import flatten_params
    from ccvs_tpu_torch.weights import load_params

    jtr, gparams, _ = gpts["cat"]
    jae, aparams, _ = aes
    _, sparams, _ = stft_models
    flat = flatten_params({"ae": aparams, "gpt": gparams, "stft": sparams}, dtype=None)
    assert "gpt/lbl_emb/embedding" in flat and "stft/quantizer/embedding" in flat
    models = {"ae": FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"),
              "gpt": TokenTransformer(port_config(jtr.cfg), dtype=torch.float32,
                                      device="cpu").model,
              "stft": StftModel(port_config(STFT), device="cpu")}
    for prefix, module in models.items():
        load_params(module, flat, prefix)
    np.testing.assert_array_equal(to_np(models["gpt"].lbl_emb.weight),
                                  flat["gpt/lbl_emb/embedding"])
    np.testing.assert_array_equal(to_np(models["stft"].quantizer.embedding),
                                  flat["stft/quantizer/embedding"])
    np.testing.assert_array_equal(to_np(models["stft"].decoder.conv4.conv.weight),
                                  flat["stft/decoder/conv4/conv/weight"])


# ---------------- class labels ----------------


def test_class_label_generation_matches_ccvs_tpu(gpts, aes):
    """Explicit labels: the forward with the label prefix within 1e-5, tokens
    equal, the video within 1e-3. Without labels the port draws them (in
    range, returned) and generates what the JAX package generates from the
    same labels."""
    jtr, gparams, ttr = gpts["cat"]
    rng = np.random.RandomState(11)
    code, lbl = rng.randint(0, 32, (2, 20)), np.array([3, 1])
    want = fast_jit(lambda v, c, lb: jtr.model.apply(v, c, lbl=lb))(
        {"params": gparams}, jnp.asarray(code), jnp.asarray(lbl))
    got = ttr.model(torch.from_numpy(code), lbl=torch.from_numpy(lbl))
    assert got.shape == want.shape == (2, 21, 32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)

    jgen, params, gen = generators(gpts, aes, "cat")
    vid = clip(3)
    want, tokens = generate_with_tokens(jgen, params, jax.random.PRNGKey(0), jnp.asarray(vid),
                                        rec=False, vid_lbl=jnp.asarray(lbl), n_ctx_frames=1)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0), rec=False,
                       vid_lbl=torch.from_numpy(lbl), n_ctx_frames=1)
    assert "vid_lbl" not in got
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(tokens["code"]))
    assert_video_close(got["fake"], want["fake"])
    other = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0), rec=False,
                         vid_lbl=torch.from_numpy(lbl[::-1].copy()), n_ctx_frames=1)
    assert not torch.equal(other["code"], got["code"])  # the label reaches the tokens

    drawn = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(1), rec=False,
                         n_ctx_frames=1)
    lbl = to_np(drawn["vid_lbl"])
    assert lbl.shape == (2,) and ((lbl >= 0) & (lbl < 5)).all()
    want, tokens = generate_with_tokens(jgen, params, jax.random.PRNGKey(0), jnp.asarray(vid),
                                        rec=False, vid_lbl=jnp.asarray(lbl), n_ctx_frames=1)
    np.testing.assert_array_equal(to_np(drawn["code"]), np.asarray(tokens["code"]))
    assert_video_close(drawn["fake"], want["fake"])


# ---------------- deblurring ----------------


@pytest.mark.parametrize("sigma", [2, 10])
def test_blur_video_matches_ccvs_tpu(sigma):
    """The port's blur on the device against the JAX package's scipy one
    (reflect mode: the edge sample repeated), within 1e-5; at sigma 10 the
    radius (15) outruns the 12-pixel frames."""
    vid = np.random.RandomState(12).uniform(-1, 1, (2, 2, 12, 20, 3)).astype(np.float32)
    want = j_blur_video(vid, sigma)
    got = blur_video(torch.from_numpy(vid), sigma)
    assert got.dtype == torch.float32 and got.shape == vid.shape
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)


def test_deblurring_generation_matches_ccvs_tpu(gpts, aes):
    """Deblurring: the blurred clip's tokens are the whole given stream, the
    decode context is the blurred frame; tokens equal, videos within 1e-3."""
    jgen, params, gen = generators(gpts, aes, "deblur")
    vid = clip(3, seed=13)
    want, tokens = generate_with_tokens(jgen, params, jax.random.PRNGKey(0), jnp.asarray(vid),
                                        rec=False, n_ctx_frames=1)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0), rec=False,
                       n_ctx_frames=1)
    np.testing.assert_allclose(to_np(got["blur"]), np.asarray(want["blur"]), rtol=1e-5,
                               atol=1e-5)
    blur_code = gen.ae.encode(got["blur"])["code"].reshape(2, -1)
    np.testing.assert_array_equal(to_np(got["state_code"]), to_np(blur_code))
    np.testing.assert_array_equal(to_np(got["state_code"]), np.asarray(tokens["state_code"]))
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(tokens["code"]))
    assert_video_close(got["fake"], want["fake"])


# ---------------- down_size ----------------


@pytest.mark.parametrize("src,dst", [(8, 4), (32, 8), (4, 8), (8, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    """``resize_frames`` against ``jax.image.resize(..., "bilinear")`` (which
    antialiases when it shrinks), down and up, within 1e-5."""
    vid = np.random.RandomState(14).uniform(-1, 1, (2, 3, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(vid), (2, 3, dst, dst, 3), "bilinear")
    got = resize_frames(torch.from_numpy(vid), dst)
    assert got.shape == (2, 3, dst, dst, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_generate_from_image_down_size_matches_ccvs_tpu(gpts, aes):
    """``generate_from_image`` (the clip length from ``cfg.data.vid_len``)
    with ``down_size``: the image degraded to 4x4 and back is the one
    context frame; the video within 1e-3. Without ``down_size`` the first
    frame is the image's own decode."""
    jgen, params, gen = generators(gpts, aes, "frame")
    gen.cfg = dataclasses.replace(gen.cfg, data=DataConfig(vid_len=3))
    jgen.cfg = jgen.cfg.replace(data=jcfg.DataConfig(vid_len=3))
    img = clip(1, seed=15)[:, 0]
    want = jgen.generate_from_image(params, jax.random.PRNGKey(0), jnp.asarray(img), down_size=4)
    got = gen.generate_from_image(torch.from_numpy(img), torch.Generator().manual_seed(0),
                                  down_size=4)
    assert "rec" not in got
    assert_video_close(got["fake"], want["fake"])
    plain = gen.generate_from_image(torch.from_numpy(img), torch.Generator().manual_seed(0))
    assert plain["fake"].shape == (2, 3, 8, 8, 3)
    assert float((plain["fake"] - got["fake"]).abs().max()) > 1e-3


# ---------------- beam search ----------------


@pytest.mark.parametrize("mode,n0,n0_state,total_len", [
    ("beam", 16, 0, 64),  # beam 3, 48 frame tokens
    ("beam_state", 16, 0, 72),  # beam 2, sampled-stream states (greedy) interleaved
    ("beam_state", 16, 8, 72),  # beam 2, the whole state stream given
])
def test_beam_search_matches_ccvs_tpu(gpts, mode, n0, n0_state, total_len):
    """The greedy beam (``sample=False``, ``no_sample``, ``top_k`` >= beam):
    beam^2 candidates pruned to the beam, the hypotheses and the KV cache
    reordered; frame and state tokens equal, given tokens kept."""
    jtr, params, ttr = gpts[mode]
    rng = np.random.RandomState(16)
    code = rng.randint(0, 32, (2, n0))
    kw = {"state_code": rng.randint(0, 16, (2, n0_state))} if n0_state else {}
    want = jtr.generate(params, jax.random.PRNGKey(0), jnp.asarray(code), total_len=total_len,
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ttr.generate(torch.from_numpy(code), torch.Generator().manual_seed(0),
                       total_len=total_len, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want["code"]))
    np.testing.assert_array_equal(to_np(got["code"][:, :n0]), code)
    if mode == "beam_state":
        np.testing.assert_array_equal(to_np(got["state_code"]), np.asarray(want["state_code"]))
        if n0_state:
            np.testing.assert_array_equal(to_np(got["state_code"][:, :n0_state]),
                                          kw["state_code"])


def test_beam_hypotheses_and_scores(gpts):
    """The beam returns its hypotheses and their summed log-probabilities:
    the best is the one ``generate`` keeps, and each score is the sum of its
    frame tokens' log-probabilities under a full forward of the hypothesis."""
    _, _, ttr = gpts["beam"]
    code = torch.from_numpy(np.random.RandomState(17).randint(0, 32, (2, 16)))
    seen = []
    fill_beam = ttr._fill_beam

    def record(*args):
        out = fill_beam(*args)
        seen.append(out)
        return out

    ttr._fill_beam = record
    try:
        got = ttr.generate(code, torch.Generator().manual_seed(0), total_len=64)
    finally:
        del ttr._fill_beam
    (hyps, log_p), = seen
    assert hyps.shape == (2, 3, 64) and log_p.shape == (2, 3)
    best = log_p.argmax(1)
    assert torch.equal(got["code"], hyps[torch.arange(2), best])
    assert len({tuple(h.tolist()) for h in hyps[0]}) == 3  # distinct hypotheses
    flat = hyps.reshape(6, 64)
    with torch.no_grad():
        logits = ttr.model(flat[:, :-1]).float()[:, 15:] / ttr.cfg.temperature
        lp = torch.log_softmax(logits.masked_fill(
            logits < logits.topk(5, dim=-1).values[..., -1:], float("-inf")), -1)
    score = lp.gather(2, flat[:, 16:, None])[..., 0].sum(1).reshape(2, 3)
    np.testing.assert_allclose(to_np(score), to_np(log_p), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("no_sample", [False, True])
def test_sampled_beam_search(gpts, no_sample):
    """The sampled beam (``sample``: one categorical draw per hypothesis and
    frame position; Gumbel top-k at the first one unless ``no_sample``): the
    random streams of the two packages differ, so this holds the port to
    what must hold whatever is drawn: given tokens kept, tokens in the
    vocabulary, the hypotheses distinct from the first generated token on,
    and the kept one the best-scored."""
    _, params, _ = gpts["beam"]
    cfg = dataclasses.replace(GPTS["beam"], sample=True, no_sample=no_sample)
    ttr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params)
    code = torch.from_numpy(np.random.RandomState(17).randint(0, 32, (2, 16)))
    seen = []
    fill_beam = ttr._fill_beam
    ttr._fill_beam = lambda *args: seen.append(fill_beam(*args)) or seen[-1]
    got = ttr.generate(code, torch.Generator().manual_seed(0), total_len=64)
    (hyps, log_p), = seen
    assert torch.equal(got["code"][:, :16], code)
    assert int(got["code"].min()) >= 0 and int(got["code"].max()) < 32
    for i in range(2):
        assert len(set(hyps[i, :, 16].tolist())) == 3
    assert torch.equal(got["code"], hyps[torch.arange(2), log_p.argmax(1)])
    assert bool(torch.isfinite(log_p).all())


# ---------------- step by step ----------------


def test_generate_chunk_fixed_matches_ccvs_tpu(gpts):
    """One chunk of a full-window buffer from position n: tokens equal, the
    tokens before n and the caller's buffer untouched."""
    jtr, params, ttr = gpts["frame"]
    merged = np.random.RandomState(18).randint(0, 32, (2, 48))
    merged[:, 32:] = 0
    want = jtr.generate_chunk_fixed(params, jax.random.PRNGKey(0), jnp.asarray(merged), 16)
    buf = torch.from_numpy(merged.copy())
    got = ttr.generate_chunk_fixed(buf, 16, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got[:, :16]), merged[:, :16])
    np.testing.assert_array_equal(to_np(buf), merged)


@pytest.mark.parametrize("mode,fixed_shape,t", [
    ("frame", True, 4),  # the buffer holds 3 frames: it slides for the third generated
    ("frame", False, 4),
    ("p2p", False, 4),  # the end frame's prefix (delta 3); the window slides
])
def test_step_by_step_matches_ccvs_tpu(gpts, aes, mode, fixed_shape, t):
    """``generate_step_by_step``: each frame decoded, re-encoded and its
    tokens replacing the predicted ones; the video within 1e-3 of the JAX
    package's, and the returned tokens the re-encodes of the frames."""
    jgen, params, gen = generators(gpts, aes, mode)
    vid = clip(t, seed=19)
    want = jitted(jgen.generate_step_by_step, params, jax.random.PRNGKey(0), jnp.asarray(vid),
                  n_ctx_frames=1, fixed_shape=fixed_shape)
    got = gen.generate_step_by_step(torch.from_numpy(vid), torch.Generator().manual_seed(0),
                                    n_ctx_frames=1, fixed_shape=fixed_shape)
    assert_video_close(got["fake"], want["fake"])
    n_gen = t - 1 - int(mode == "p2p")
    assert got["code"].shape == (2, (1 + n_gen) * 16)
    reenc = gen.ae.encode(got["fake"][:, :1 + n_gen])["code"].reshape(2, -1)
    np.testing.assert_array_equal(to_np(got["code"][:, 16:]), to_np(reenc[:, 16:]))
    if mode == "p2p":
        np.testing.assert_array_equal(to_np(got["fake"][:, -1]), vid[:, -1])

