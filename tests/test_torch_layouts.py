"""Layouts in ccvs_tpu_torch against ccvs_tpu, on the CPU in fp32: the layout
encoder and the decoder's "layout" and "both" modes, the autoencoder's
layout twins (``encode_layout``, ``merge_layout_inters``,
``embed_layout_code``), ``decode_video_layout`` with given and with
re-encoded layouts, layout-conditioned generation (greedy: the layout
tokens sampled past the context, or all given, and the rec rollout), the
image and video G losses' layout terms with the shared and with a separate
decoder, one transformer step on layout tokens, and the weights' round trip
into ``ccvs_tpu``.

The JAX sides run under ``jax.jit`` on seeded fp32 parameters
(``torch_parity.jax_params``), carried across by ``weights.py``. Each test
states its tolerance."""

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
from ccvs_tpu.port.npz_params import flatten_params, unflatten_params
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu_torch.config import Config
from ccvs_tpu_torch.generate import VideoGenerator
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.nn.decoder import SkipDecoder
from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer
from ccvs_tpu_torch.weights import export_params
from test_torch_ae_train import jax_models, port_models, port_tree
from test_torch_train import close, largest
from test_train import AE_CFG
from torch_parity import (fast_jit, few_threads, jax_params, load_into, port_config, set_fp32,
                          to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

N_CLS = 3
# two resolutions at 8x8 px, three layout classes
AE = jcfg.AutoencoderConfig(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
    max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3), use_layout=True,
    layout_size=N_CLS, same_decoder_layout=True)
AES = {"shared": AE, "separate": dataclasses.replace(AE, same_decoder_layout=False)}
# layout tokens are the control stream: 16 a frame from the layout codebook
GPT = jcfg.TransformerConfig(
    z_num=32, z_len=96, z_chunk=32, num_blocks=3, cond_len=16, n_layer=2, n_head=2, n_embd=32,
    z_shape=(4, 4), emb_mode="temporal", top_k=1, top_k_state=1, sample_state=True,
    layout=True, state_num=32, state_size=16)
T = 3


def clip(seed, b=2, t=T):
    """Frames in [-1, 1] and their layouts: a smooth random field's
    quantiles, three classes in blobs."""
    rng = np.random.RandomState(seed)
    vid = rng.uniform(-1, 1, (b, t, 8, 8, 3)).astype(np.float32)
    field = vid.mean(-1) + 0.5 * np.roll(vid[..., 0], 1, axis=-1)
    lay = np.digitize(field, np.quantile(field, [1 / 3, 2 / 3])).astype(np.int32)
    return vid, lay


@pytest.fixture(scope="module")
def aes():
    """Per decoder arrangement: the JAX autoencoder, its seeded params and
    the port's autoencoder holding them."""
    out = {}
    for i, (name, cfg) in enumerate(AES.items()):
        jae = JAE(cfg, dtype=F32)
        params = jax_params(jae.init, seed=i)
        tae = load_into(FrameAutoencoder(port_config(cfg), dtype=torch.float32, device="cpu"),
                        params)
        out[name] = (jae, params, tae)
    return out


@pytest.mark.parametrize("name", list(AES))
def test_layout_encoder_and_decoder_modes_match_ccvs_tpu(aes, name):
    """The layout encoder on one-hot layouts (latents and context
    features), and the decoder: "both" (shared: image and layout latents
    in, a frame and layout logits out) or "layout" (separate), against one
    context, within 1e-4 of the largest entry."""
    jae, params, tae = aes[name]
    vid, lay = clip(0)
    soft = jax.nn.one_hot(jnp.asarray(lay[:, 0]), N_CLS)
    want_z, want_i = fast_jit(lambda p, x: jae.encoder_l.apply({"params": p}, x))(
        params["encoder_l"], soft)
    got_z, got_i = tae.encoder_l(tae.one_hot_layout(torch.from_numpy(lay[:, 0])))
    close(got_z.detach(), want_z, rel_atol=1e-5)
    for g, w in zip(got_i, want_i):
        close(g.detach(), w, rel_atol=1e-5)
    rng = np.random.RandomState(1)
    inters = [rng.normal(0, 1, s).astype(np.float32) for s in jae.inter_shapes(2)]
    shared = name == "shared"
    zc = AE.z_size * (2 if shared else 1)
    z = rng.normal(0, 1, (2, 4, 4, zc)).astype(np.float32)
    jdec, key, tdec = ((jae.decoder, "decoder", tae.decoder) if shared
                       else (jae.decoder_l, "decoder_l", tae.decoder_l))
    want = fast_jit(lambda p, z, i: jdec.apply({"params": p}, z, [i]))(
        params[key], jnp.asarray(z), [jnp.asarray(f) for f in inters])
    got = tdec(torch.from_numpy(z), SkipDecoder.stack_contexts([[torch.from_numpy(f)
                                                                 for f in inters]]))
    if shared:
        assert got[0].shape == (2, 8, 8, 3) and got[1].shape == (2, 8, 8, N_CLS)
        close(got[0].detach(), want[0], rel_atol=1e-4)
        close(got[1].detach(), want[1], rel_atol=1e-4)
    else:
        assert got.shape == (2, 8, 8, N_CLS) and want[1] is None
        close(got.detach(), want[0], rel_atol=1e-4)


def test_layout_twins_match_ccvs_tpu(aes):
    """``encode_layout`` (codes equal, latents and context features within
    1e-5 of the largest entry), ``merge_layout_inters`` (equal) and
    ``embed_layout_code`` (equal) on a clip's layouts."""
    jae, params, tae = aes["shared"]
    _, lay = clip(2)
    want = fast_jit(jae.encode_layout)(params, jnp.asarray(lay))
    got = tae.encode_layout(torch.from_numpy(lay))
    assert got["code"].shape == (2, T, 16)
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want["code"]))
    close(got["z"], want["z"], rel_atol=1e-5)
    for g, w in zip(got["inter"], want["inter"]):
        close(g, w, rel_atol=1e-5)
    rng = np.random.RandomState(3)
    img = [rng.normal(0, 1, f.shape).astype(np.float32) for f in want["inter"]]
    merged = FrameAutoencoder.merge_layout_inters([torch.from_numpy(f) for f in img], got["inter"])
    for g, w in zip(merged, JAE.merge_layout_inters([jnp.asarray(f) for f in img], want["inter"])):
        close(g, w, rtol=0, rel_atol=1e-6)
    np.testing.assert_array_equal(
        to_np(tae.embed_layout_code(got["code"])),
        np.asarray(jae.embed_layout_code(params, want["code"])))


@pytest.mark.parametrize("given", [False, True], ids=["re_encoded", "given"])
def test_decode_video_layout_matches_ccvs_tpu(aes, given):
    """The layout rollout from one context frame: each frame's image and
    layout logits within 1e-4 of the largest entry, their argmax equal; its
    context refresh re-encodes the argmax of its own layout logits, or
    takes the given layouts' features (``interl_gen``)."""
    jae, params, tae = aes["shared"]
    vid, lay = clip(4)
    rng = np.random.RandomState(5)
    codes, lcodes = rng.randint(0, 32, (2, T, 16)), rng.randint(0, 32, (2, T, 16))
    jinterl = tinterl = None
    if given:
        jenc = fast_jit(jae.encode_layout)(params, jnp.asarray(lay))
        jinterl = [f[:, 1:] for f in jenc["inter"]]
        tinterl = [f[:, 1:] for f in tae.encode_layout(torch.from_numpy(lay))["inter"]]
    want_v, want_l = fast_jit(lambda p, c, lc, f, l, i: jae.decode_video_layout(
        p, c, lc, f, l, n_ctx=1, interl_gen=i))(params, jnp.asarray(codes), jnp.asarray(lcodes),
                                              jnp.asarray(vid[:, :1]), jnp.asarray(lay[:, :1]),
                                              jinterl)
    got_v, got_l = tae.decode_video_layout(torch.from_numpy(codes), torch.from_numpy(lcodes),
                                           torch.from_numpy(vid[:, :1]),
                                           torch.from_numpy(lay[:, :1]), n_ctx=1,
                                           interl_gen=tinterl)
    assert got_v.shape == (2, T, 8, 8, 3) and got_l.shape == (2, T, 8, 8, N_CLS)
    close(got_v, want_v, rel_atol=1e-4)
    close(got_l, want_l, rel_atol=1e-4)
    np.testing.assert_array_equal(to_np(got_l.argmax(-1)), np.asarray(want_l.argmax(-1)))


@pytest.fixture(scope="module")
def gpt():
    jtr = JTT(GPT, dtype=F32)
    params = jax_params(lambda k: jtr.init(k, batch=2), seed=10)
    ttr = TokenTransformer(port_config(GPT), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params)
    return jtr, params, ttr


@pytest.mark.parametrize("keep", [False, True], ids=["sampled", "kept"])
def test_layout_generation_matches_ccvs_tpu(aes, gpt, keep, tmp_path):
    """``generate(layout=...)``, greedy: the layout tokens are the control
    stream (sampled past the context frame, or all given with
    ``keep_state``); the given layout tokens kept, ``fake_layout`` equal,
    ``fake`` within 1e-3, ``real_layout`` the input. Sampled, also the rec
    rollout (``rec`` within 1e-3, ``rec_layout`` equal), and ``save_batch``
    writes the three layout videos as the JAX package's, byte for byte."""
    jae, aparams, tae = aes["shared"]
    jtr, gparams, ttr = gpt
    vid, lay = clip(6)
    rec = not keep
    jgen = JGen(jcfg.Config(ae=AE, gpt=GPT), jae, jtr)
    want = fast_jit(lambda p, r, v, l: jgen.generate(p, r, v, layout=l, keep_state=keep,
                                                     rec=rec))(
        {"ae": aparams, "gpt": gparams}, jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(lay))
    gen = VideoGenerator(Config(ae=tae.cfg, gpt=ttr.cfg), tae, ttr)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0),
                       layout=torch.from_numpy(lay), keep_state=keep, rec=rec)
    lcode = to_np(tae.encode_layout(torch.from_numpy(lay))["code"]).reshape(2, -1)
    n = T * 16 if keep else 16
    np.testing.assert_array_equal(to_np(got["state_code"])[:, :n], lcode[:, :n])
    names = ("fake", "rec") if rec else ("fake",)
    for k in names:
        assert got[k + "_layout"].shape == (2, T, 8, 8)
        np.testing.assert_array_equal(to_np(got[k + "_layout"]), np.asarray(want[k + "_layout"]))
        close(got[k], want[k], rtol=1e-3, rel_atol=1e-3)
    np.testing.assert_array_equal(to_np(got["real_layout"]), lay)
    if not rec:
        assert "rec" not in got and "rec_layout" not in got
        return
    layouts = ("real_layout", "fake_layout", "rec_layout")
    JGen.save_batch(None, str(tmp_path / "jax"), 0, 2, vid,
                    {k: np.asarray(want[k]) for k in layouts})
    VideoGenerator.save_batch(str(tmp_path / "port"), 0, 2, torch.from_numpy(vid),
                              {k: got[k] for k in layouts})
    for k in layouts:
        for i in range(2):
            name = f"{k}/vid_{i:05d}.avi"
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# ---------------- the G losses' layout terms ----------------

# the discriminators off: the layout terms do not reach them, and their
# graphs would double the JAX side's compile
TRAIN = {name: dataclasses.replace(AE_CFG, use_layout=True, layout_size=N_CLS,
                                   same_decoder_layout=shared, use_di=False, use_dv=False)
         for name, shared in (("shared", True), ("separate", False))}


def _layout_batch(seed, kind):
    rng = np.random.RandomState(seed)
    h = AE_CFG.max_dim
    if kind == "img":
        return {"img": (rng.randn(6, h, h, 3) * 0.3).astype(np.float32),
                "flow_img": rng.randn(2, h, h, 2).astype(np.float32),
                "mask_img": (rng.rand(2, h, h, 1) > 0.5).astype(np.float32),
                "layout": rng.randint(0, N_CLS, (6, h, h)).astype(np.int32)}
    return {"vid": (rng.randn(2, AE_CFG.vid_len, h, h, 3) * 0.3).astype(np.float32),
            "layout": rng.randint(0, N_CLS, (2, AE_CFG.vid_len, h, h)).astype(np.int32)}


@pytest.mark.parametrize("name,kind", [("shared", "img"), ("shared", "vid"),
                                       ("separate", "img")])
def test_generator_losses_layout_terms_match_ccvs_tpu(name, kind):
    """The image G loss (shared decoder or ``decoder_l``) and the video G
    loss (shared decoder; the JAX package's video loss has no separate
    one) with layouts: every term (``layout_quant_*``, ``layout_img`` /
    ``layout_vid`` among them) within rtol 1e-5, the gradient of every
    generator parameter (the layout twins' included) within rtol 1e-4 plus
    1e-4 of the largest entry."""
    cfg = TRAIN[name]
    jlosses, gen, disc = jax_models(cfg)
    losses = port_models(cfg, gen, disc)
    batch = _layout_batch(11, kind)
    fn = jlosses.img_generator_loss if kind == "img" else jlosses.vid_generator_loss
    (jloss, (jm, _)), jgrad = fast_jit(jax.value_and_grad(
        lambda g, b: fn(g, disc, None, b, jax.random.PRNGKey(0)), has_aux=True))(
        gen, {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = losses.img_generator_loss if kind == "img" else losses.vid_generator_loss
    loss, (m, _) = tfn({k: torch.from_numpy(v) for k, v in batch.items()})
    params = dict(losses.ae.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    want_keys = {f"layout_quant_{kind}", f"layout_{kind}"}
    assert want_keys <= set(m) and set(m) == set(jm), set(m) ^ set(jm)
    for k, v in jm.items():
        assert float(m[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-8), k
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = port_tree(losses.ae, jgrad)
    scale = largest(want.values())
    for (n, p), g in zip(params.items(), grads):
        close(torch.zeros_like(p) if g is None else g, want[n], rtol=1e-4, rel_atol=1e-4,
              scale=scale, what=n)
    assert any(n.startswith("encoder_l") for n in params)
    assert any(n.startswith("decoder_l") for n in params) == (name == "separate")


def test_transformer_step_on_layout_tokens_matches_ccvs_tpu(aes):
    """``TransformerTrainer.encode_batch`` with ``gpt.layout``: the frame
    tokens and the layout tokens (``state_code``, the layout encoder over
    ``ENCODE_FRAMES`` frames a pass and one nearest-code search) equal to
    the JAX package's ``encode`` / ``encode_layout``; one AdamW step on
    them: ``nll``, ``state_nll`` and ``gnorm`` within rtol 1e-5, the
    parameters after it within 1e-6."""
    jae, aparams, tae = aes["shared"]
    cfg = dataclasses.replace(GPT, lr=1e-3, lr_warmup_iter=0)
    vid, lay = clip(8, b=4)
    jcodes = fast_jit(lambda p, v: jae.encode(p, v)["code"])(aparams, jnp.asarray(vid))
    jl = fast_jit(lambda p, l: jae.encode_layout(p, l)["code"])(aparams, jnp.asarray(lay))
    jbatch = {"code": jcodes.reshape(4, -1), "state_code": jl.reshape(4, -1)}
    jtr = JTT(cfg, dtype=F32)
    params = jax_params(lambda k: jtr.init(k, batch=2), seed=12)
    jinit, jstep = jsteps.make_transformer_step(jtr, cfg, 10)
    jstate, jm = jstep(jinit(params), jbatch)
    tcfg = Config(ae=tae.cfg, gpt=port_config(cfg), n_iter=10)
    trainer = TransformerTrainer(tcfg, tae, dtype=torch.float32, device="cpu")
    load_into(trainer.transformer.model, params)
    batch = trainer.encode_batch({"vid": torch.from_numpy(vid), "layout": torch.from_numpy(lay)})
    np.testing.assert_array_equal(to_np(batch["code"]), np.asarray(jbatch["code"]))
    np.testing.assert_array_equal(to_np(batch["state_code"]), np.asarray(jbatch["state_code"]))
    state, m = trainer.step(trainer.init_state(), batch)
    for k in ("nll", "state_nll", "gnorm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    want = port_tree(trainer.transformer.model, jstate.params)
    for n, p in trainer.transformer.model.named_parameters():
        close(p.detach(), want[n], rtol=1e-6, rel_atol=1e-6, what=n)


@pytest.mark.parametrize("name", list(AES))
def test_layout_weights_round_trip_into_ccvs_tpu(aes, name):
    """``export_params`` of an autoencoder with layout twins gives the JAX
    package's tree exactly (``encoder_l``, ``quantizer_l`` and, separate,
    ``decoder_l``; the shared decoder's ``rgb_head``, ``refine_layout`` and
    ``layout_head``), and the JAX ``encode_layout`` on it gives the port's
    codes."""
    jae, params, tae = aes[name]
    flat = export_params(tae)
    want = flatten_params(params, dtype=None)
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)
    heads = {k.split("/")[1] for k in flat if k.startswith("decoder/")}
    assert {"rgb_head", "refine_layout", "layout_head"} <= heads if name == "shared" else True
    assert any(k.startswith("decoder_l/") for k in flat) == (name == "separate")
    tree = jax.tree_util.tree_map(jnp.asarray, unflatten_params(flat))
    _, lay = clip(9)
    np.testing.assert_array_equal(
        np.asarray(fast_jit(lambda p, l: jae.encode_layout(p, l)["code"])(tree, jnp.asarray(lay))),
        to_np(tae.encode_layout(torch.from_numpy(lay))["code"]))
