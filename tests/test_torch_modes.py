"""The controllable serving modes of ccvs_tpu_torch against ccvs_tpu, on the
CPU in fp32: the state model, the GPT's state / start / cond embeddings,
token generation with state tokens, the point-to-point prefix, the start
token and the sliding window, the video pipeline of each mode, and the int8
decode step.

Sampling is greedy in both packages (``top_k=1``, ``top_k_state=1``: one
finite logit per draw), so the two random streams never matter. The JAX side
runs under ``jax.jit`` on seeded fp32 parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.generate import VideoGenerator as JGen
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import StateModel as JStateModel
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.nn import quantized as jq
from ccvs_tpu.nn.gpt import cache_to_layers as j_cache_to_layers
from ccvs_tpu_torch.config import Config
from ccvs_tpu_torch.generate import VideoGenerator, square_trajectory
from ccvs_tpu_torch.models import FrameAutoencoder, StateModel, TokenTransformer
from ccvs_tpu_torch.nn import quantized as tq
from ccvs_tpu_torch.nn.gpt import cache_to_layers
from torch_parity import (fast_jit, few_threads, jax_params, load_into, port_config, set_fp32,
                          to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

# two resolutions at 8x8 px: the cheapest autoencoder with the whole decode
AE = jcfg.AutoencoderConfig(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(4, 4),
    max_dim=8, inter_p=0.5, skip_memory=3, skip_context=(1, 2, 3), serve_fused=True)
BASE = jcfg.TransformerConfig(
    z_num=32, z_len=48, z_chunk=16, num_blocks=4, cond_len=16, n_layer=2, n_head=2, n_embd=32,
    z_shape=(4, 4), emb_mode="temporal", top_k=1, top_k_state=1)
STATE = dict(state=True, state_num=8, state_size=2, sample_state=True)
GPTS = {
    "frame": BASE,
    "state": dataclasses.replace(BASE, z_len=54, z_chunk=18, **STATE),
    "state_front": dataclasses.replace(BASE, z_len=54, z_chunk=18, state_front=True, **STATE),
    "p2p": dataclasses.replace(BASE, p2p=True),
    "unc": dataclasses.replace(BASE, use_start_token=True, cond_len=0),
}
SCFG = jcfg.StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)


@pytest.fixture(scope="module")
def gpts():
    """Per mode: the JAX transformer, its seeded params and the port's
    transformer holding them."""
    out = {}
    for i, (name, cfg) in enumerate(GPTS.items()):
        jtr = JTT(cfg, dtype=F32)
        params = jax_params(lambda k: jtr.init(k, batch=2), seed=10 + i)
        ttr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
        load_into(ttr.model, params)
        out[name] = (jtr, params, ttr)
    return out


@pytest.fixture(scope="module")
def state_models():
    jsm = JStateModel(SCFG)
    params = jax_params(jsm.init, seed=3)
    # a scalar codebook spread over [0, 1], as trained ones are
    params["quantizer"]["embedding"] = jnp.asarray(
        np.random.RandomState(4).uniform(0, 1, (SCFG.state_num, 1)).astype(np.float32))
    tsm = load_into(StateModel(port_config(SCFG), device="cpu"), params)
    return jsm, params, tsm


@pytest.fixture(scope="module")
def aes():
    jae = JAE(AE, dtype=F32)
    params = jax_params(jae.init, seed=0)
    tae = load_into(FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"), params)
    return jae, params, tae


def test_state_model_matches_ccvs_tpu(state_models):
    """Estimate within 1e-5, state tokens equal, their decode equal."""
    jsm, params, tsm = state_models
    z = np.random.RandomState(5).normal(0, 1, (2, 3, 4, 4, 16)).astype(np.float32)
    want = np.asarray(fast_jit(jsm.estimate)(params, jnp.asarray(z)))
    got = tsm.estimate(torch.from_numpy(z))
    assert got.shape == (2, 3, 2)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)
    encode = jax.jit(lambda p, s: jsm.encode(p, state=s))
    want_code = np.asarray(encode(params, jnp.asarray(want)))
    got_code = tsm.encode(z=torch.from_numpy(z))
    assert want_code.shape == (2, 6)
    np.testing.assert_array_equal(to_np(got_code), want_code)
    # states spread over [0, 1] reach every code
    states = np.random.RandomState(6).uniform(0, 1, (2, 40, 2)).astype(np.float32)
    want_code = np.asarray(encode(params, jnp.asarray(states)))
    got_code = tsm.encode(state=torch.from_numpy(states))
    np.testing.assert_array_equal(to_np(got_code), want_code)
    assert len(np.unique(want_code)) == SCFG.state_num
    np.testing.assert_array_equal(to_np(tsm.decode(got_code)),
                                  np.asarray(jsm.decode(params, jnp.asarray(want_code))))


@pytest.mark.parametrize("mode", ["state", "state_front", "p2p", "unc"])
def test_gpt_forward_with_prefixes_matches_ccvs_tpu(gpts, mode):
    """Full forward with state tokens (interleaved or in front), the p2p
    cond prefix with a per-batch ``delta``, or the start token: logits within
    1e-5."""
    jtr, params, ttr = gpts[mode]
    rng = np.random.RandomState(6)
    code = rng.randint(0, 32, (2, 30))
    kw = {}
    if mode.startswith("state"):
        kw["state_code"] = rng.randint(0, 8, (2, 4))
    if mode == "p2p":
        kw["cond_code"], kw["delta"] = rng.randint(0, 32, (2, 16)), np.array([1, 3])
    want = fast_jit(lambda v, c, kw: jtr.model.apply(v, c, **kw))(
        {"params": params}, jnp.asarray(code), {k: jnp.asarray(v) for k, v in kw.items()})
    got = ttr.model(torch.from_numpy(code), **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# (mode, given frame tokens, given state tokens, p2p delta, total_len)
GEN_CASES = {
    "state": ("state", 16, 2, None, 54),
    "state_front": ("state_front", 16, 2, None, 54),
    "keep_state": ("state", 16, 8, None, 72),  # the whole state stream given
    "state_none_given": ("state", 16, 0, None, 54),  # body[0], a state, is generated
    "p2p": ("p2p", 16, 0, 2, 48),
    "unc": ("unc", 0, 0, None, 48),
    "window_frame": ("frame", 16, 0, None, 96),  # 6 frames through a 3-frame window
    "window_state": ("state", 16, 2, None, 90),
    "window_p2p": ("p2p", 16, 0, 3, 80),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_tokens_match_ccvs_tpu(gpts, case):
    """``TokenTransformer.generate``: frame and state tokens equal, given
    tokens kept, for each mode, within one window and across slides."""
    mode, n0, n0_state, delta, total_len = GEN_CASES[case]
    jtr, params, ttr = gpts[mode]
    rng = np.random.RandomState(7)
    code = rng.randint(0, 32, (2, n0))
    kw = {}
    if n0_state:
        kw["state_code"] = rng.randint(0, 8, (2, n0_state))
    if delta is not None:
        kw["cond_code"], kw["delta"] = rng.randint(0, 32, (2, 16)), np.full(2, delta)
    want = jtr.generate(params, jax.random.PRNGKey(0), jnp.asarray(code),
                        total_len=total_len, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ttr.generate(torch.from_numpy(code), torch.Generator().manual_seed(0),
                       total_len=total_len, **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want["code"]))
    np.testing.assert_array_equal(to_np(got["code"][:, :n0]), code)
    if mode.startswith("state"):
        np.testing.assert_array_equal(to_np(got["state_code"]), np.asarray(want["state_code"]))
        if n0_state:
            np.testing.assert_array_equal(to_np(got["state_code"][:, :n0_state]),
                                          kw["state_code"])
    else:
        assert got["state_code"] is None and want["state_code"] is None


@pytest.mark.parametrize("mode", ["state", "p2p", "unc"])
def test_video_generator_matches_ccvs_tpu(gpts, aes, state_models, mode):
    """``VideoGenerator.generate`` end to end: tokens equal, the video within
    1e-3; with states the real and generated states too; in p2p mode the
    last frame is the real end frame (and the others decode against the end
    frame's features); unconditional, ``decode_video`` runs with no context
    frame."""
    jtr, gparams, ttr = gpts[mode]
    jae, aparams, tae = aes
    jsm, sparams, tsm = state_models
    t = 3
    vid = np.random.RandomState(8).uniform(-1, 1, (2, t, 8, 8, 3)).astype(np.float32)
    n_ctx = 0 if mode == "unc" else 1
    jgen = JGen(jcfg.Config(ae=AE, gpt=jtr.cfg, state=SCFG), jae, jtr, state_model=jsm)
    want = fast_jit(lambda p, r, v: jgen.generate(p, r, v, rec=False, n_ctx_frames=n_ctx))(
        {"ae": aparams, "gpt": gparams, "state": sparams}, jax.random.PRNGKey(0),
        jnp.asarray(vid))
    gen = VideoGenerator(Config(ae=tae.cfg, gpt=ttr.cfg), tae, ttr, state_model=tsm)
    got = gen.generate(torch.from_numpy(vid), torch.Generator().manual_seed(0), rec=False,
                       n_ctx_frames=n_ctx)
    assert got["fake"].shape == (2, t, 8, 8, 3)
    np.testing.assert_allclose(to_np(got["fake"]), np.asarray(want["fake"]), rtol=1e-3, atol=1e-3)
    size = AE.tokens_per_frame
    if mode == "p2p":
        np.testing.assert_array_equal(to_np(got["fake"][:, -1]), vid[:, -1])
        assert got["code"].shape == (2, (t - 1) * size)
    if mode == "state":
        np.testing.assert_allclose(to_np(got["state"]), np.asarray(want["state"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(to_np(got["fake_state"]), np.asarray(want["fake_state"]))
        assert got["fake_state"].shape == (2, t, 2)
        # the context frame's state tokens are its real ones
        real_code = to_np(tsm.encode(state=got["state"]))
        np.testing.assert_array_equal(to_np(got["state_code"])[:, :2], real_code[:, :2])


def test_custom_square_state_matches_ccvs_tpu(aes, state_models):
    """The square trajectory from the estimated first state."""
    jae, aparams, tae = aes
    jsm, sparams, tsm = state_models
    from ccvs_tpu.generate import square_trajectory as j_square

    init = np.array([[[0.5, 0.5]], [[0.3, 0.7]]], np.float32)
    np.testing.assert_allclose(to_np(square_trajectory(torch.from_numpy(init), 12)),
                               np.asarray(j_square(init, 12)), rtol=0, atol=1e-7)
    vid = np.random.RandomState(10).uniform(-1, 1, (2, 4, 8, 8, 3)).astype(np.float32)
    # the JAX package's custom_square_state, its steps jitted
    code = jae.get_jit_encode()(aparams, jnp.asarray(vid[:, :1]))["code"]
    first = fast_jit(lambda c: jsm.estimate(sparams, jae.embed_code(aparams, c)))(code)
    want = j_square(first, 4)
    gen = VideoGenerator(Config(ae=tae.cfg, gpt=port_config(GPTS["state"])), tae, None,
                         state_model=tsm)
    got = gen.custom_square_state(torch.from_numpy(vid))
    assert got.shape == (2, 4, 2)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_generate_refuses_modes_not_ported(gpts, aes):
    """Every mode of the JAX package's ``generate`` is ported
    (``tests/test_torch_serving.py`` and ``tests/test_torch_layouts.py``
    hold the others): a ``layout`` is ignored without ``cfg.gpt.layout``,
    as there, and ``cfg.gpt.layout`` without the autoencoder's layout twins
    raises."""
    _, _, ttr = gpts["frame"]
    _, _, tae = aes
    gen = VideoGenerator(Config(ae=tae.cfg, gpt=ttr.cfg), tae, ttr)
    vid = torch.zeros(1, 2, 8, 8, 3)
    lay = torch.zeros(1, 2, 8, 8, dtype=torch.long)
    plain = gen.generate(vid, torch.Generator().manual_seed(0), rec=False)
    with_lay = gen.generate(vid, torch.Generator().manual_seed(0), rec=False, layout=lay)
    assert "fake_layout" not in with_lay and torch.equal(with_lay["fake"], plain["fake"])
    gcfg = dataclasses.replace(ttr.cfg, layout=True, state_num=32, state_size=16)
    with pytest.raises(ValueError, match="layout twins"):
        VideoGenerator(Config(ae=tae.cfg, gpt=gcfg), tae, ttr).generate(
            vid, torch.Generator(), layout=lay)


# ---------------- int8 ----------------


def test_quantize_gpt_int8_matches_ccvs_tpu(gpts):
    """``w8`` bit-equal (round half to even in both packages), scales within 1e-7."""
    _, params, ttr = gpts["frame"]
    want = jq.quantize_gpt_int8(params)  # eager, as the JAX package's generate calls it
    got = tq.quantize_gpt_int8(ttr.model)
    for group, names in (("attn", ("query", "key", "value", "proj")), ("mlp", ("fc1", "fc2"))):
        for name in names:
            for layer, q in enumerate(got["layers"]):
                w = want[group][name]
                np.testing.assert_array_equal(to_np(q[group][name]["w8"]).T,
                                              np.asarray(w["w8"][layer]))
                np.testing.assert_allclose(to_np(q[group][name]["scale"]),
                                           np.asarray(w["scale"][layer]), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(to_np(got["head"]["w8"]).T, np.asarray(want["head"]["w8"]))


def test_decode_step_int8_matches_ccvs_tpu(gpts):
    """One int8 decode step at a filled cache, position an int32 tensor on
    the device as the serving loop gives it: logits within 1e-5, and the
    cache written at that position."""
    jtr, params, ttr = gpts["frame"]
    cfg = jtr.cfg
    rng = np.random.RandomState(11)
    shape = (cfg.n_layer, 2, cfg.n_head, 128, cfg.n_embd // cfg.n_head)
    ck, cv = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    emb1 = rng.normal(0, 1, (2, 1, cfg.n_embd)).astype(np.float32)
    pos = 40
    step = fast_jit(lambda q, e, p, c: jq.decode_step_fn_int8(cfg, params, q, e, p, c, dtype=F32))
    want, jcache = step(jq.quantize_gpt_int8(params), jnp.asarray(emb1),
                        jnp.asarray(pos, jnp.int32),
                        j_cache_to_layers((jnp.asarray(ck), jnp.asarray(cv))))
    cache = cache_to_layers((torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())))
    with torch.no_grad():
        got = tq.decode_step_fn_int8(ttr.model, tq.quantize_gpt_int8(ttr.model),
                                     torch.from_numpy(emb1),
                                     torch.tensor([pos], dtype=torch.int32), cache)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    for ours, theirs in zip(cache, jcache):
        for layer in range(cfg.n_layer):
            np.testing.assert_allclose(to_np(ours[layer]), np.asarray(theirs[layer]),
                                       rtol=1e-5, atol=1e-5)


def test_int8_product_is_exact_beyond_fp32():
    """Sums past 2^24 (where fp32 drops units): the CPU product equals the
    exact integer one, and the JAX package's int32 ``dot_general``."""
    rng = np.random.RandomState(12)
    x8 = np.full((2, 4096), 127, np.int8)
    x8[1] = rng.randint(-127, 128, 4096)
    w8 = np.full((8, 4096), 127, np.int8)
    w8[:, 0] = rng.randint(-127, 128, 8)  # odd sums above 2^24: not fp32 numbers
    exact = x8.astype(np.int64) @ w8.astype(np.int64).T
    assert np.abs(exact).max() > 2**24 and (exact[0] % 2).any()
    got = tq.int8_matmul(torch.from_numpy(x8), torch.from_numpy(w8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), exact)
    want = jax.lax.dot_general(jnp.asarray(x8), jnp.asarray(w8.T), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert (exact.astype(np.float32).astype(np.int64) != exact).any()  # fp32 would not do


@pytest.mark.parametrize("inner,out,with_bias", [(64, 32, True), (4096, 48, False)])
def test_int8_linear_matches_ccvs_tpu_dot_int8(inner, out, with_bias):
    """The int8 product with its activation quantization, scaling and bias
    (K3's plain version) bit-equal to the JAX package's ``_dot_int8`` run
    eagerly, op by op (under ``jax.jit`` XLA fuses the scaling and the bias
    into one multiply-add, an ulp away), with exact halves in x (rounded to
    even) and an odd sum past 2^24 (not an fp32 number)."""
    rng = np.random.RandomState(14)
    x = rng.normal(0, 1, (2, inner)).astype(np.float32)
    x[0, :4] = [127.0, 0.5, 2.5, -1.5]  # scale 1: x / s lands on halves
    x[0, 4:] = np.clip(x[0, 4:], -1, 1)
    x[1] = 1.0
    x[1, 0] = 0.5
    w = rng.normal(0, 0.05, (inner, out)).astype(np.float32)
    w[:, 0] = 0.05  # row 1, output 0: an odd sum of 127 x 127 terms, past 2^24 at 4096
    bias = rng.normal(0, 1, out).astype(np.float32) if with_bias else None
    jqw = jq._quant_w(jnp.asarray(w))
    want = jq._dot_int8(jnp.asarray(x), jqw, None if bias is None else jnp.asarray(bias))
    qw = tq._quant_w(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(to_np(qw["w8"]).T, np.asarray(jqw["w8"]))
    got = tq._dot_int8_shared(torch.from_numpy(x),
                              tq._product(qw, None if bias is None else torch.from_numpy(bias)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    x8, _ = tq._quant_x(torch.from_numpy(x))
    assert x8[0, :4].tolist() == [127, 0, 2, -2]
    acc = int(tq.int8_matmul(x8, qw["w8"])[1, 0])
    assert acc == 127 * (127 * (inner - 1) + int(x8[1, 0])) and acc % 2


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_int8_qkv_matches_ccvs_tpu_dot_int8(batch):
    """q, k and v as one product on the same input (x quantized once, K3's
    plain version) bit-equal to the JAX package's ``_dot_int8`` run eagerly
    three times on that input: exact halves in x (rounded to even) and, past
    two rows, an all-zero row (scale 1e-8 / 127)."""
    rng = np.random.RandomState(15 + batch)
    x = rng.normal(0, 1, (batch, 64)).astype(np.float32)
    x[0, :4] = [127.0, 0.5, 2.5, -1.5]  # scale 1: x / s lands on halves
    x[0, 4:] = np.clip(x[0, 4:], -1, 1)
    x[1] = 1.0
    x[1, 0] = 0.5
    if batch > 2:
        x[-1] = 0.0
    ws = [rng.normal(0, 0.05, (64, 32)).astype(np.float32) for _ in range(3)]
    biases = [rng.normal(0, 1, 32).astype(np.float32) for _ in range(3)]
    want = [np.asarray(jq._dot_int8(jnp.asarray(x), jq._quant_w(jnp.asarray(w)),
                                    jnp.asarray(b))) for w, b in zip(ws, biases)]
    qws = [tq._quant_w(torch.from_numpy(w.T.copy())) for w in ws]
    qkv = tq.Int8Linear([q["w8"] for q in qws], [q["scale"] for q in qws],
                        [torch.from_numpy(b) for b in biases])
    got = tq._dot_int8_shared(torch.from_numpy(x), qkv)
    assert got.dtype == torch.float32 and got.shape == (3, batch, 32)
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(to_np(ours), theirs)


def test_decode_step_int8_launches_four_products_a_layer(gpts, monkeypatch):
    """The int8 step makes 4 shared-input products a layer (q/k/v as one)
    and the head's: 6 a layer in the JAX package."""
    _, _, ttr = gpts["frame"]
    model = ttr.model
    calls = []
    shared = tq._dot_int8_shared
    monkeypatch.setattr(tq, "_dot_int8_shared", lambda x, p: calls.append(len(p.w8s)) or
                        shared(x, p))
    nl, d = model.cfg.n_layer, model.cfg.n_embd
    cache = tuple([torch.zeros(2, model.cfg.n_head, 8, d // model.cfg.n_head)
                   for _ in range(nl)] for _ in range(2))
    with torch.no_grad():
        tq.decode_step_fn_int8(model, tq.quantize_gpt_int8(model), torch.ones(2, 1, d), 0, cache)
    assert calls == [3, 1, 1, 1] * nl + [1]


def test_serve_int8_greedy_tokens_match_ccvs_tpu(gpts):
    """``serve_int8``: the weights quantized once per ``generate``, every
    decode step in int8; greedy tokens equal."""
    _, params, _ = gpts["frame"]
    cfg = dataclasses.replace(BASE, serve_int8=True)
    jtr = JTT(cfg, dtype=F32)
    ttr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
    load_into(ttr.model, params)
    code = np.random.RandomState(13).randint(0, 32, (2, 16))
    want = jtr.generate(params, jax.random.PRNGKey(0), jnp.asarray(code), total_len=48)
    got = ttr.generate(torch.from_numpy(code), torch.Generator().manual_seed(0), total_len=48)
    np.testing.assert_array_equal(to_np(got["code"]), np.asarray(want["code"]))
