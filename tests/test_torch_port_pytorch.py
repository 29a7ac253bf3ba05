"""The reference-checkpoint loader of ccvs_tpu_torch
(``ccvs_tpu_torch/port/port_pytorch.py``) against ccvs_tpu's, on the CPU in
fp32.

No reference checkpoint is in the repository, so the state dicts are
synthetic, under the reference's key names (``skip_autoencoder.py``,
``mingpt.py``, ``gan.py``), built here as ``tests/test_port.py`` builds
them. Each goes through both packages' ``port_*`` functions: the trees are
equal array for array, and the port's modules loaded from them
(``load_ported``) compute what the JAX package's compute from its tree."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu import config as jcfg
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.models.transformer import ContinuousTransformer as JCT
from ccvs_tpu.nn import discriminators as jdisc
from ccvs_tpu.nn.decoder import interblock_schedule
from ccvs_tpu.port import port_pytorch as jpp
from ccvs_tpu.port.npz_params import flatten_params
from ccvs_tpu_torch import config as tcfg
from ccvs_tpu_torch.models import (ContinuousTransformer, FrameAutoencoder, StateModel,
                                   StftModel, TokenTransformer)
from ccvs_tpu_torch.nn import discriminators as tdisc
from ccvs_tpu_torch.port import port_pytorch as tpp
from ccvs_tpu_torch.weights import export_params
from torch_parity import few_threads, jax_params, port_config, set_fp32, to_np

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

AE = jcfg.AutoencoderConfig(
    necf=8, necf_mult=(1, 2, 4), ndcf=8, ndcf_mult=(1, 2, 4), z_size=16, z_num=32,
    z_shape=(4, 4), max_dim=16, inter_p=0.5, skip_memory=2, skip_context=(1, 2))
GPT = jcfg.TransformerConfig(
    z_num=32, z_len=48, z_chunk=16, num_blocks=4, n_layer=3, n_head=2, n_embd=32,
    z_shape=(2, 4), emb_mode="temporal", top_k=1)


def synth_encoder_sd(cfg, rng, in_size=3):
    """A SkipGANEncoder state dict (``skip_autoencoder.py:309-351``)."""
    sd = {}
    chans = list(cfg.enc_channels)

    def conv(prefix, cin, cout, k, down=False, bias=True):
        ci = 1 if down else 0
        sd[f"{prefix}.{ci}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)
        if bias:
            sd[f"{prefix}.{ci}.bias"] = rng.randn(cout).astype(np.float32)

    conv("blocks.0", in_size, chans[0], 1)
    for i in range(1, len(chans)):
        p = f"blocks.{i}"
        conv(f"{p}.conv1", chans[i - 1], chans[i - 1], 3)
        conv(f"{p}.conv2", chans[i - 1], chans[i], 3, down=True)
        conv(f"{p}.skip", chans[i - 1], chans[i], 1, down=True, bias=False)
    conv(f"blocks.{len(chans)}", chans[-1], cfg.z_size, 1)
    return sd


def synth_decoder_sd(cfg, rng, out_size=3):
    """A SkipGANDecoder state dict with its ``inter_blocks``: the upsampling
    ConvLayers keep their conv at index 0."""
    sd = {}
    chans = list(cfg.dec_channels)
    sched = interblock_schedule(cfg.num_resolutions)

    def conv(prefix, cin, cout, k, bias=True):
        sd[f"{prefix}.0.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)
        if bias:
            sd[f"{prefix}.0.bias"] = rng.randn(cout).astype(np.float32)

    conv("blocks.0", cfg.z_size, chans[0], 1)
    for i in range(1, len(chans)):
        p = f"blocks.{i}"
        conv(f"{p}.conv1", chans[i - 1], chans[i - 1], 3)
        conv(f"{p}.conv2", chans[i - 1], chans[i], 3)
        conv(f"{p}.skip", chans[i - 1], chans[i], 1, bias=False)
    conv(f"blocks.{len(chans)}", chans[-1], out_size, 1)
    for i in range(cfg.num_resolutions):
        s, k = cfg.inter_sizes_dec[i], sched[i]["kernel"]
        mp = f"inter_blocks.{i}.matching"
        if i > 0:
            sd[f"{mp}.upsample_flow.weight"] = rng.randn(2, 1, 4, 4).astype(np.float32)
            sd[f"{mp}.upsample_occ.weight"] = rng.randn(1, 1, 4, 4).astype(np.float32)
        if s > 16:
            conv(f"{mp}.proj", s, max(16, s // 4), 1)
        if sched[i]["corr_stride"] != 1:
            sd[f"{mp}.upsample_corr.weight"] = rng.randn(49, 1, 4, 4).astype(np.float32)
        for head, cin in ((mp, 49), (f"inter_blocks.{i}.subpixel", 2 * s + 3)):
            conv(f"{head}.convs.0", cin, 128, 3)
            conv(f"{head}.convs.1", 128, 64, 3)
            conv(f"{head}.convs.2", 64, 32, 3)
            conv(f"{head}.flow_head", 32, 2, k)
            conv(f"{head}.occ_head", 32, 1, k)
    return sd


def synth_gpt_sd(cfg, rng, scale=0.1):
    """A minGPT state dict (``mingpt.py:120-305``) under ``cfg.emb_mode``,
    with state, start-token and label embeddings where ``cfg`` has them."""
    d, (h, w) = cfg.n_embd, cfg.z_shape

    def r(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {"tok_emb.weight": r(cfg.z_num, d)}
    if cfg.emb_mode == "temporal":
        sd["s_emb"], sd["t_emb"] = r(1, h * w, d), r(1, cfg.num_blocks, d)
    elif cfg.emb_mode == "spatio-temporal":
        sd["h_emb"], sd["w_emb"], sd["t_emb"] = r(1, h, d), r(1, w, d), r(1, cfg.num_blocks, d)
    else:
        sd["pos_emb"] = r(1, cfg.num_blocks * h * w, d)
    if cfg.state_size > 0:
        sd["state_tok_emb.weight"] = r(cfg.state_num, d)
        if cfg.emb_mode is None:
            sd["state_pos_emb"] = r(1, cfg.num_blocks * cfg.state_size, d)
        else:
            sd["state_s_emb"] = r(1, cfg.state_size, d)
    if cfg.use_start_token:
        sd["start_tok_emb"] = r(1, d)
    if cfg.cat:
        sd["lbl_emb.weight"] = r(cfg.num_lbl, d)
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{p}.{ln}.weight"] = 1 + r(d)
            sd[f"{p}.{ln}.bias"] = r(d)
        for m in ("key", "query", "value", "proj"):
            sd[f"{p}.attn.{m}.weight"] = r(d, d)
            sd[f"{p}.attn.{m}.bias"] = r(d)
        sd[f"{p}.mlp.0.weight"], sd[f"{p}.mlp.0.bias"] = r(4 * d, d), r(4 * d)
        sd[f"{p}.mlp.3.weight"], sd[f"{p}.mlp.3.bias"] = r(d, 4 * d), r(d)
    sd["ln_f.weight"], sd["ln_f.bias"] = 1 + r(d), r(d)
    sd["head.weight"] = r(max(cfg.z_num, cfg.state_num), d)
    return sd


def synth_image_discriminator_sd(shapes, rng):
    """A ``gan.py`` image discriminator's state dict with the shapes of the
    JAX ``ImageDiscriminator``'s tree ``shapes``: each activated
    ConvLayer's bias in its FusedLeakyReLU (the index after the conv), the
    downsampling ones' conv after a Blur (index 1)."""
    sd = {}

    def conv(prefix, tree, down=False):
        ci = 1 if down else 0
        sd[f"{prefix}.{ci}.weight"] = rng.randn(*tree["conv"]["weight"].shape)
        if "act_bias" in tree:
            sd[f"{prefix}.{ci + 1}.bias"] = rng.randn(*tree["act_bias"].shape)
        if "bias" in tree["conv"]:
            sd[f"{prefix}.{ci}.bias"] = rng.randn(*tree["conv"]["bias"].shape)

    conv("convs.0", shapes["conv0"])
    i = 1
    while f"res{i}" in shapes:
        res = shapes[f"res{i}"]
        conv(f"convs.{i}.conv1", res["conv1"])
        conv(f"convs.{i}.conv2", res["conv2"], down=True)
        conv(f"convs.{i}.skip", res["skip"], down=True)
        i += 1
    conv("final_conv", shapes["final_conv"])
    for j in (0, 1):
        for leaf in ("weight", "bias"):
            sd[f"final_linear.{j}.{leaf}"] = rng.randn(*shapes[f"fc{j + 1}"][leaf].shape)
    return {k: v.astype(np.float32) for k, v in sd.items()}


@dataclasses.dataclass
class Options:
    """A pickled object of the test's own, as a training script's options."""

    lr: float


def jtree(tree):
    return flatten_params(tree, dtype=None)


def assert_trees_equal(got, want):
    """Two ``port_*`` trees: the same keys, every array bit-equal."""
    got, want = tpp.flatten(got), jtree(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_load_torch_state_dict(tmp_path):
    """A saved ``.pth`` state dict reads back as numpy arrays; a file that
    holds other pickled objects raises (``weights_only=True``)."""
    rng = np.random.RandomState(0)
    sd = {"embedding.weight": torch.from_numpy(rng.randn(8, 4).astype(np.float32))}
    path = tmp_path / "qvid_q_latest_net_0.pth"
    torch.save(sd, path)
    got = tpp.load_torch_state_dict(str(path))
    assert set(got) == {"embedding.weight"} and isinstance(got["embedding.weight"], np.ndarray)
    np.testing.assert_array_equal(got["embedding.weight"], sd["embedding.weight"].numpy())
    bad = tmp_path / "pickled.pth"
    torch.save({"opt": Options(1e-3)}, bad)
    with pytest.raises(pickle.UnpicklingError):
        tpp.load_torch_state_dict(str(bad))


@pytest.mark.parametrize("layouts", [False, True])
def test_port_autoencoder_matches_ccvs_tpu(layouts):
    """``port_autoencoder`` (with the layout twins ``qvid_{el,ql,gl}``): the
    tree equal to the JAX package's; the port's autoencoder loaded from it
    encodes and reconstructs as the JAX one does from its tree (codes equal,
    latents and frames within 1e-5 of the largest entry)."""
    cfg = dataclasses.replace(AE, use_layout=True, layout_size=5) if layouts else AE
    rng = np.random.RandomState(1)
    sds = {"qvid_e": synth_encoder_sd(cfg, rng), "qvid_g": synth_decoder_sd(cfg, rng),
           "qvid_q": {"embedding.weight": rng.randn(cfg.z_num, cfg.z_size).astype(np.float32)}}
    if layouts:
        sds["qvid_el"] = synth_encoder_sd(cfg, rng, in_size=5)
        sds["qvid_gl"] = synth_decoder_sd(cfg, rng, out_size=5)
        sds["qvid_ql"] = {"embedding.weight": rng.randn(cfg.z_num, cfg.z_size)
                          .astype(np.float32)}
    want = jpp.port_autoencoder(cfg, sds)
    got = tpp.port_autoencoder(port_config(cfg), sds)
    assert_trees_equal(got, want)
    tae = tpp.load_ported(FrameAutoencoder(port_config(cfg), dtype=torch.float32, device="cpu"),
                          got)
    jae = JAE(cfg, dtype=F32)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jenc = jax.jit(jae.encode)(want, jnp.asarray(x))
    tenc = tae.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tenc["code"]), np.asarray(jenc["code"]))
    z = np.asarray(jenc["z"])
    np.testing.assert_allclose(to_np(tenc["z"]), z, atol=1e-5 * np.abs(z).max())
    jrec = np.asarray(jax.jit(lambda p, z, i: jae.decode_frame(
        p, z, [f[:, None] for f in i], jnp.ones((2, 1)))[0])(want, jenc["z"], jenc["inter"]))
    trec = tae.decode_frame(tenc["z"], [f[:, None] for f in tenc["inter"]], torch.ones(2, 1))
    np.testing.assert_allclose(to_np(trec), jrec, atol=1e-5 * np.abs(jrec).max())


GPT_CASES = {
    "temporal": {},
    "spatio_temporal": dict(emb_mode="spatio-temporal"),
    "none": dict(emb_mode=None),
    "none_state": dict(emb_mode=None, z_len=60, state=True, state_num=8, state_size=2),
    "spatio_temporal_start_labels": dict(emb_mode="spatio-temporal", use_start_token=True,
                                         cat=True, num_lbl=5),
}


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_port_gpt_matches_ccvs_tpu(case):
    """``port_gpt`` under each ``emb_mode`` (with state tokens, a start
    token and labels): the tree equal to the JAX package's (kernels the
    transposed Linear weights, the blocks stacked); the port's GPT loaded
    from it gives the JAX GPT's logits within 1e-5 of the largest entry,
    and ``export_params`` gives the JAX tree back."""
    cfg = dataclasses.replace(GPT, **GPT_CASES[case])
    rng = np.random.RandomState(3)
    sd = synth_gpt_sd(cfg, rng)
    want = jpp.port_gpt(cfg, sd)
    got = tpp.port_gpt(port_config(cfg), sd)
    assert_trees_equal(got, want)
    np.testing.assert_array_equal(got["core"]["blocks"]["block"]["fc1"]["kernel"][1],
                                  sd["blocks.1.mlp.0.weight"].T)
    ttr = TokenTransformer(port_config(cfg), dtype=torch.float32, device="cpu")
    tpp.load_ported(ttr.model, got)
    code = rng.randint(0, cfg.z_num, (2, 20))
    kw = {}
    if cfg.state:
        kw["state_code"] = rng.randint(0, cfg.state_num, (2, 4))
    if cfg.cat:
        kw["lbl"] = np.array([1, 4])
    jlogits = np.asarray(jax.jit(lambda p, c, kw: JTT(cfg, dtype=F32).model.apply(
        {"params": p}, c, **kw))(want, jnp.asarray(code), {k: jnp.asarray(v)
                                                            for k, v in kw.items()}))
    tlogits = to_np(ttr.model(torch.from_numpy(code), **{k: torch.from_numpy(v)
                                                         for k, v in kw.items()}))
    np.testing.assert_allclose(tlogits, jlogits, atol=1e-5 * np.abs(jlogits).max())
    back = export_params(ttr.model)
    for k, v in jtree(want).items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_port_discriminator_state_estimator_and_stft_match_ccvs_tpu():
    """``port_image_discriminator``, ``port_state_estimator`` and
    ``port_stft``: trees equal to the JAX package's, and each loads into the
    port's module (every parameter filled, every key used)."""
    rng = np.random.RandomState(4)
    acfg = AE
    jdi = jdisc.ImageDiscriminator(acfg)
    shapes = jax.eval_shape(lambda k: jdi.init(k, jnp.zeros((2, 16, 16, 3)))["params"],
                            jax.random.PRNGKey(0))
    sd = synth_image_discriminator_sd(shapes, rng)
    want = jpp.port_image_discriminator(acfg, sd)
    got = tpp.port_image_discriminator(port_config(acfg), sd)
    assert_trees_equal(got, want)
    tpp.load_ported(tdisc.ImageDiscriminator(port_config(acfg)), got)

    scfg = jcfg.StateConfig(z_size=16, z_shape=(4, 4), state_hsize=8, state_size=2, state_num=8)
    sd = {"convs.0.1.weight": rng.randn(8, 16, 3, 3).astype(np.float32),
          "convs.0.1.bias": rng.randn(8).astype(np.float32),
          "convs.1.1.weight": rng.randn(8, 8, 3, 3).astype(np.float32),
          "convs.1.1.bias": rng.randn(8).astype(np.float32),
          "fc.weight": rng.randn(2, 8).astype(np.float32), "fc.bias": rng.randn(2)
          .astype(np.float32)}
    want = jpp.port_state_estimator(scfg, sd)
    got = tpp.port_state_estimator(port_config(scfg), sd)
    assert_trees_equal(got, want)
    sm = StateModel(port_config(scfg), device="cpu")
    tpp.load_ported(sm, {"estimator": got, "quantizer": tpp.port_quantizer(
        {"embedding.weight": rng.rand(8, 1).astype(np.float32)})})

    fcfg = jcfg.StftConfig()
    stft = StftModel(port_config(fcfg), device="cpu")
    tree = {k.replace(".", "/"): v.detach().numpy() for k, v in stft.state_dict().items()}
    enc_sd, dec_sd = {}, {}
    for i in range(5):
        ci = 1 if 1 <= i <= 3 else 0
        for leaf in ("weight", "bias"):
            enc_sd[f"convs.{i}.{ci}.{leaf}"] = rng.randn(
                *tree[f"encoder/conv{i}/conv/{leaf}"].shape).astype(np.float32)
            dec_sd[f"convs.{i}.0.{leaf}"] = rng.randn(
                *tree[f"decoder/conv{i}/conv/{leaf}"].shape).astype(np.float32)
    want = jpp.port_stft(fcfg, enc_sd, dec_sd)
    got = tpp.port_stft(port_config(fcfg), enc_sd, dec_sd)
    assert_trees_equal(got, want)
    got["quantizer"] = tpp.port_quantizer(
        {"embedding.weight": rng.randn(*tree["quantizer/embedding"].shape).astype(np.float32)})
    tpp.load_ported(stft, got)


def test_block_delta_and_prune_mismatched_match_ccvs_tpu():
    """``apply_block_delta`` (renumbered ``blocks`` / ``inter_blocks``, other
    keys kept) and ``prune_mismatched`` (keys of other shapes dropped) give
    the JAX package's dicts."""
    rng = np.random.RandomState(5)
    sd = synth_decoder_sd(AE, rng)
    sd["extra.weight"] = rng.randn(3).astype(np.float32)
    for delta in (-1, 2):
        want = jpp.apply_block_delta(sd, delta)
        got = tpp.apply_block_delta(sd, delta)
        assert list(got) == list(want)
        assert all(got[k] is want[k] for k in want)
    assert "blocks.3.conv1.0.weight" in tpp.apply_block_delta(sd, 1)
    shapes = {k: v.shape for k, v in sd.items()}
    shapes["blocks.0.0.weight"] = (1, 2, 3, 4)
    shapes["extra.weight"] = (4,)
    want = jpp.prune_mismatched(sd, shapes, verbose=False)
    got = tpp.prune_mismatched(sd, shapes, verbose=False)
    assert list(got) == list(want) and len(got) == len(sd) - 2
    assert "blocks.0.0.weight" not in got and "extra.weight" not in got


def test_port_decoder_refuses_options_the_port_lacks():
    """``use_tradeoff``, ``no_corr`` and ``no_proj`` (and ``use_inter``
    off) cannot reach the port's ``port_decoder``: ``Config.from_json``
    refuses a JAX config that sets one. At their defaults the port's
    config gives the JAX package's tree."""
    for over in (dict(use_tradeoff=True), dict(no_corr=True), dict(no_proj=True),
                 dict(use_inter=False)):
        cfg = jcfg.Config(ae=dataclasses.replace(AE, **over))
        with pytest.raises(ValueError, match=next(iter(over))):
            tcfg.Config.from_json(cfg.to_json())
    sd = synth_decoder_sd(AE, np.random.RandomState(6))
    ported = tcfg.Config.from_json(jcfg.Config(ae=AE).to_json()).ae
    assert_trees_equal(tpp.port_decoder(ported, sd), jpp.port_decoder(AE, sd))


CONT = jcfg.TransformerConfig(z_len=16, n_layer=2, n_head=2, n_embd=32, is_continuous=True,
                              n_in=8)


def cgpt_head_sd(seed):
    """A 1-proposal CGPT's reference-keyed head weight ``(n_in, D)``."""
    rng = np.random.RandomState(seed)
    return {"head.weight": (rng.randn(CONT.n_in, CONT.n_embd) * 0.3).astype(np.float32)}


def test_apply_head_to_n_gives_copies_of_the_one_proposal_head():
    """The port's ``apply_head_to_n``: a 1-proposal CGPT's head expanded to 3
    and loaded into ``CGPT(n_proposals=3)`` (the rest of its parameters the
    1-proposal model's) predicts in every proposal what the 1-proposal
    model predicts, bit for bit, with every logit 0."""
    one = ContinuousTransformer(port_config(CONT), dtype=torch.float32, device="cpu").init(0)
    with torch.no_grad():
        one.model.head.weight.copy_(torch.from_numpy(cgpt_head_sd(7)["head.weight"]))
    cfg3 = dataclasses.replace(CONT, n_proposals=3)
    three = ContinuousTransformer(port_config(cfg3), dtype=torch.float32, device="cpu")
    sd = {k: v for k, v in one.model.state_dict().items()}
    sd = tpp.apply_head_to_n({k: v.numpy() for k, v in sd.items()}, 3)
    assert sd["head.weight"].shape == (3 * (CONT.n_in + 1), CONT.n_embd)
    three.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 9, CONT.n_in).astype(np.float32))
    with torch.no_grad():
        want = one.model(x)
        logits, props = three.model(x)
    assert torch.equal(logits, torch.zeros_like(logits))
    for p in range(3):
        assert torch.equal(props[:, :, p], want)
    # the rollout picks the first of the equal proposals
    np.testing.assert_array_equal(to_np(three.generate(x[:, :4], 9)), to_np(one.generate(x[:, :4],
                                                                                        9)))


def test_jax_apply_head_to_n_is_not_read_as_copies_by_its_cgpt():
    """The JAX package's ``apply_head_to_n`` stacks ``[3 x values; 3 zero
    rows]``, while its ``CGPT`` reads its head as 3 groups of ``[logit,
    values]``: loaded into the JAX ``CGPT(n_proposals=3)``, its proposals are
    not the 1-proposal prediction and its logits not 0. Kept as a test so
    that the difference by design of the port's ``apply_head_to_n`` stays
    visible (ROADMAP.md)."""
    jone = JCT(CONT, dtype=F32)
    params = jax_params(jone.init)
    params["head"]["kernel"] = cgpt_head_sd(7)["head.weight"].T
    cfg3 = dataclasses.replace(CONT, n_proposals=3)
    sd = jpp.apply_head_to_n(cgpt_head_sd(7), 3)
    p3 = dict(params, head={"kernel": sd["head.weight"].T})
    x = jnp.asarray(np.random.RandomState(8).randn(2, 9, CONT.n_in).astype(np.float32))
    want = np.asarray(jax.jit(jone.model.apply)({"params": params}, x))
    apply3 = jax.jit(JCT(cfg3, dtype=F32).model.apply)
    logits, props = apply3({"params": p3}, x)
    gap = max(float(np.abs(np.asarray(props[:, :, p]) - want).max()) for p in range(3))
    print(f"JAX apply_head_to_n: proposals up to {gap:.3g} from the 1-proposal prediction, "
          f"logits up to {float(np.abs(np.asarray(logits)).max()):.3g}")
    assert gap > 0.1 and float(np.abs(np.asarray(logits)).max()) > 0.1
    # the port's expansion, read by the same JAX CGPT, gives copies (within
    # rounding: XLA blocks the wider product otherwise)
    p3 = dict(params, head={"kernel": tpp.apply_head_to_n(cgpt_head_sd(7), 3)["head.weight"].T})
    logits, props = apply3({"params": p3}, x)
    assert float(np.abs(np.asarray(logits)).max()) == 0.0
    for p in range(3):
        np.testing.assert_allclose(np.asarray(props[:, :, p]), want,
                                   atol=1e-6 * np.abs(want).max())
