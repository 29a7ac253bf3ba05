"""ccvs_tpu_torch networks against ccvs_tpu's on the CPU, in fp32: the same
numpy inputs and the same (ccvs_tpu-initialised) weights through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.nn import layers as jl
from ccvs_tpu.nn.gpt import cache_to_layers as j_cache_to_layers
from ccvs_tpu.nn.gpt import decode_step_fn as j_decode_step_fn
from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
from ccvs_tpu_torch.nn import layers as tl
from ccvs_tpu_torch.nn.gpt import cache_to_layers, decode_step_fn
from ccvs_tpu_torch.weights import load_npz, load_params
from torch_parity import AE, GPT, jax_params, load_into, port_config, set_fp32, to_np

F32 = set_fp32()


def _layer_pair(jmod, tmod, x, *args, **kwargs):
    params = jax_params(lambda k: jmod.init(k, jnp.asarray(x), *args, **kwargs).get("params", {}))
    want = jax.jit(lambda p, x, *a: jmod.apply({"params": p}, x, *a, **kwargs))(
        params, jnp.asarray(x), *args)
    load_into(tmod, params)
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, (np.ndarray, jax.Array)) else a
             for a in args]
    tkw = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, (np.ndarray, jax.Array)) else v
           for k, v in kwargs.items()}
    return np.asarray(want), to_np(tmod(torch.from_numpy(x), *targs, **tkw))


@pytest.mark.parametrize("name", ["conv_shared", "conv_transpose", "linear", "blur_up",
                                  "conv_down", "conv_up", "resblock_down", "resblock_up",
                                  "to_rgb"])
def test_layers(rng, name):
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    if name == "conv_shared":
        # conv(concat([tile(shared, k), x])) with the shared block convolved once
        shared = rng.randn(1, 8, 8, 4).astype(np.float32)
        pair = (jl.EqualConv2d(10, 5, 3, padding=1), tl.EqualConv2d(10, 5, 3, padding=1),
                (), {"shared": shared, "k": 2})
    elif name == "conv_transpose":
        pair = (jl.EqualConv2d(6, 5, 3, stride=2, transpose=True),
                tl.EqualConv2d(6, 5, 3, stride=2, transpose=True), (), {})
    elif name == "linear":
        x = rng.randn(3, 6).astype(np.float32)
        pair = (jl.EqualLinear(6, 4, bias_init=0.5, lr_mul=0.1, activation="fused_lrelu"),
                tl.EqualLinear(6, 4, bias_init=0.5, lr_mul=0.1, activation="fused_lrelu"),
                (), {})
    elif name == "blur_up":
        pair = (jl.Blur(pad=(2, 1), upsample_factor=2), tl.Blur(pad=(2, 1), upsample_factor=2),
                (), {})
    elif name == "conv_down":
        pair = (jl.ConvLayerAE(6, 5, 3, downsample=True), tl.ConvLayerAE(6, 5, 3, downsample=True),
                (), {})
    elif name == "conv_up":
        pair = (jl.ConvLayerAE(6, 5, 1, upsample=True), tl.ConvLayerAE(6, 5, 1, upsample=True),
                (), {})
    elif name == "resblock_down":
        pair = (jl.ResBlockAE(6, 8, downsample=True), tl.ResBlockAE(6, 8, downsample=True), (), {})
    elif name == "resblock_up":
        pair = (jl.ResBlockAE(6, 8, upsample=True), tl.ResBlockAE(6, 8, upsample=True), (), {})
    else:
        skip = rng.randn(2, 4, 4, 3).astype(np.float32)
        pair = (jl.ToRGB(6), tl.ToRGB(6), (skip,), {})
    jmod, tmod, args, kwargs = pair
    want, got = _layer_pair(jmod, tmod, x, *args, **kwargs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_flatten_vid_roundtrip():
    x = torch.zeros(2, 3, 4, 4, 5)
    flat, t = tl.flatten_vid(x)
    assert flat.shape == (6, 4, 4, 5) and t == 3
    assert tl.unflatten_vid(flat, t).shape == x.shape
    assert tl.flatten_vid(flat)[1] is None


@pytest.fixture(scope="module")
def autoencoders():
    jae = JAE(AE, dtype=F32)
    params = jax_params(jae.init)
    tae = load_into(FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"),
                    params)
    return jae, params, tae


def test_encode(rng, autoencoders):
    """Codes equal; z_q and every context level within 1e-4."""
    jae, params, tae = autoencoders
    vid = rng.uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jae.encode)(params, jnp.asarray(vid))
    got = tae.encode(torch.from_numpy(vid))
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want["code"]))
    np.testing.assert_allclose(to_np(got["z"]), np.asarray(want["z"]), rtol=1e-4, atol=1e-4)
    assert len(got["inter"]) == len(want["inter"]) == 4
    for g, w in zip(got["inter"], want["inter"]):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(tae.embed_code(got["code"])),
                               np.asarray(jax.jit(jae.embed_code)(params, want["code"])),
                               rtol=0, atol=0)


def test_decode_frame_against_masked_fifo(rng, autoencoders):
    """One rollout step's decode: three FIFO slots, one of them masked out."""
    jae, params, tae = autoencoders
    z = rng.randn(2, 4, 4, 16).astype(np.float32)
    fifo = [rng.randn(*s[:1], 3, *s[1:]).astype(np.float32) for s in jae.inter_shapes(2)]
    mask = np.asarray([[0, 1, 1], [0, 0, 1]], np.float32)
    want_rgb, _ = jax.jit(jae.decode_frame)(
        params, jnp.asarray(z), [jnp.asarray(f) for f in fifo], jnp.asarray(mask))
    got_rgb = tae.decode_frame(torch.from_numpy(z), [torch.from_numpy(f) for f in fifo],
                               torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got_rgb), np.asarray(want_rgb), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def transformers():
    jtr = JTT(GPT, dtype=F32)
    params = jax_params(lambda k: jtr.init(k, batch=2))
    ttr = TokenTransformer(port_config(GPT), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params)
    return jtr, params, ttr


def test_gpt_full_logits(rng, transformers):
    jtr, params, ttr = transformers
    code = rng.randint(0, 64, (2, 40))
    want = jax.jit(jtr.model.apply)({"params": params}, jnp.asarray(code))
    got = ttr.model(torch.from_numpy(code))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def j_decode(transformers):
    """The JAX package's prefill (of a (2, n) code over a 32-long cache) and
    cached decode step (``j_decode_step_fn``, position traced), jitted once
    for the module."""
    jtr, params, _ = transformers
    jm = jtr.model
    s_idx, t_idx = np.arange(32) % 16, np.arange(32) // 16

    @jax.jit
    def j_prefill(code):
        n = code.shape[1]
        cache = jm.apply({"params": params}, 2, 32, method=type(jm).init_cache)
        emb = jm.apply({"params": params}, code, 0, jnp.asarray(s_idx[:n]),
                       jnp.asarray(t_idx[:n]), method=type(jm).embed_one)
        return j_cache_to_layers(jm.apply({"params": params}, emb, cache,
                                          method=type(jm).prefill)[1])

    @jax.jit
    def j_step(tok, s, t, pos, cache):
        emb1 = jm.apply({"params": params}, tok, 0, s, t, method=type(jm).embed_one)[:, None]
        return j_decode_step_fn(GPT, params, emb1, pos, cache, dtype=F32)

    return j_prefill, j_step


def test_gpt_prefill_then_cached_steps_equal_full_forward(rng, transformers, j_decode):
    """Prefill of 20 tokens, then 12 single-token decode steps through the
    cache (K2's plain version on the CPU): every step's logits equal the full
    forward's, and the JAX package's decode step."""
    _, _, ttr = transformers
    model = ttr.model
    code = torch.from_numpy(rng.randint(0, 64, (2, 32)))
    full = to_np(model(code))
    s_idx = torch.arange(32) % 16
    t_idx = torch.arange(32) // 16
    cache = model.init_cache(2, 32)
    assert cache[0].shape == (2, 2, 4, 128, 16)  # length rounded up to 128
    logits, cache = model.prefill(model.embed_one(code[:, :20], s_idx[:20], t_idx[:20]), cache)
    np.testing.assert_allclose(to_np(logits), full[:, :20], rtol=1e-4, atol=1e-4)
    layers = cache_to_layers(cache)

    j_prefill, j_step = j_decode
    jcache = j_prefill(jnp.asarray(code[:, :20].numpy()))
    for j in range(20, 32):
        emb1 = model.embed_one(code[:, j], int(s_idx[j]), int(t_idx[j]))[:, None]
        step = to_np(decode_step_fn(model, emb1, j, layers))
        np.testing.assert_allclose(step, full[:, j], rtol=1e-4, atol=1e-4)
        # the method form; writing the same keys and values again is a no-op
        np.testing.assert_array_equal(to_np(model.decode_step(emb1, j, layers)[0]), step)
        jstep, jcache = j_step(jnp.asarray(code[:, j].numpy()), int(s_idx[j]), int(t_idx[j]),
                               j, jcache)
        np.testing.assert_allclose(step, np.asarray(jstep), rtol=1e-4, atol=1e-4)


def test_gpt_decode_step_with_device_position(rng, transformers, j_decode):
    """The decode step driven by an int32 position tensor of shape (1,),
    advanced in place once per step as the serving loop does: the same
    logits and cache contents as the int path (exactly), and the JAX
    package's decode step with a traced position (1e-4)."""
    _, _, ttr = transformers
    model = ttr.model
    code = torch.from_numpy(rng.randint(0, 64, (2, 32)))
    s_idx = torch.arange(32) % 16
    t_idx = torch.arange(32) // 16
    caches = []
    for _ in range(2):
        cache = model.init_cache(2, 32)
        model.prefill(model.embed_one(code[:, :20], s_idx[:20], t_idx[:20]), cache)
        caches.append(cache)
    by_int, by_tensor = (cache_to_layers(c) for c in caches)

    j_prefill, j_step = j_decode
    jcache = j_prefill(jnp.asarray(code[:, :20].numpy()))
    pos = torch.full((1,), 20, dtype=torch.int32)
    for j in range(20, 32):
        emb1 = model.embed_one(code[:, j], int(s_idx[j]), int(t_idx[j]))[:, None]
        want = to_np(decode_step_fn(model, emb1, j, by_int))
        got = to_np(decode_step_fn(model, emb1, pos, by_tensor))
        np.testing.assert_array_equal(got, want)
        jstep, jcache = j_step(jnp.asarray(code[:, j].numpy()), int(s_idx[j]), int(t_idx[j]),
                               jnp.asarray(j, jnp.int32), jcache)
        np.testing.assert_allclose(got, np.asarray(jstep), rtol=1e-4, atol=1e-4)
        pos += 1
    assert int(pos) == 32
    for a, b in zip(caches[0], caches[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for layer in range(model.cfg.n_layer):
        for ours, theirs in zip(by_tensor, jcache):
            np.testing.assert_allclose(to_np(ours[layer]), np.asarray(theirs[layer]),
                                       rtol=1e-4, atol=1e-4)


def test_weights_loader_npz_and_rejects_missing_and_extra_keys(transformers, tmp_path):
    from ccvs_tpu.port.npz_params import flatten_params, save_params_npz

    _, params, ttr = transformers
    flat = flatten_params(params, dtype=None)
    save_params_npz(str(tmp_path / "w.npz"), gpt=params)  # fp16, as committed weights are
    other = TokenTransformer(ttr.cfg, dtype=torch.float32, device="cpu")
    load_npz(other.model, str(tmp_path / "w.npz"), prefix="gpt")
    for name, p in other.model.named_parameters():
        torch.testing.assert_close(p, dict(ttr.model.named_parameters())[name].half().float())
    extra = dict(flat, **{"core/unused/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="no parameter"):
        load_params(ttr.model, extra)
    missing = {k: v for k, v in flat.items() if k != "head/kernel"}
    with pytest.raises(KeyError, match="not in the input"):
        load_params(ttr.model, missing)
    assert flat["core/blocks/block/attn/query/kernel"].shape == (2, 64, 64)
