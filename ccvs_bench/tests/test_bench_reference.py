"""The plain reference against the program at small sizes on the CPU, in
fp32: the encode's codes, the rollout decode, the GPT's logits, three
training steps (losses, the first gradient, the change) and the top-k rule
of the token sampler. The test imports both; the reference imports nothing
of the program."""

import dataclasses

import pytest
import torch

from ccvs_bench import common, weights
from ccvs_bench.reference import ae as ref_ae
from ccvs_bench.reference import gpt as ref_gpt
from ccvs_bench.reference.precision import exact

NAMES = ["bairhd", "kinetics600"]


def port_models(cfg):
    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer

    pcfg = common.port_config(cfg)
    ae_p = {k: v.float() for k, v in weights.make_ae(cfg["ae"], 7, "cpu").items()}
    gpt_p = {k: v.float() for k, v in weights.make_gpt(cfg["gpt"], 7, "cpu").items()}
    ae = FrameAutoencoder(pcfg.ae, dtype=torch.float32, device="cpu")
    ae.load_state_dict(ae_p, strict=True)
    tr = TokenTransformer(pcfg.gpt, dtype=torch.float32, device="cpu", param_dtype=torch.float32)
    tr.model.load_state_dict(gpt_p, strict=True)
    return pcfg, ae, tr, ae_p, gpt_p


def clips(cfg, b, t, seed=3):
    d = cfg["ae"]["max_dim"]
    return weights.smooth_clips(weights.generator("cpu", seed, 0), (b, t, d, d, 3), "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_encode_and_rollout_decode(name, small_config):
    cfg = small_config(name)
    _, ae, _, p, _ = port_models(cfg)
    vid = clips(cfg, 2, 5)
    enc = ae.encode(vid)
    z, _ = ref_ae.encode(p, cfg["ae"], vid.flatten(0, 1).permute(0, 3, 1, 2), exact)
    codes = ref_ae.nearest_codes(z.permute(0, 2, 3, 1).flatten(0, 2), p["quantizer.embedding"],
                                 exact)
    assert torch.equal(codes.reshape(enc["code"].shape), enc["code"].long())
    assert enc["code"].unique().numel() > 8  # the latent-drawn codebook is used widely
    got = ae.decode_video(enc["code"], ctx_frames=vid[:, :1], n_ctx=1)
    want = ref_ae.decode_video(p, cfg["ae"], enc["code"], vid[:, 0].permute(0, 3, 1, 2), exact)
    want = want.permute(0, 1, 3, 4, 2)
    assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_gpt_logits(name, small_config):
    cfg = small_config(name)
    _, _, tr, _, p = port_models(cfg)
    code = torch.randint(0, cfg["gpt"]["z_num"], (3, 200),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = tr.model(code)
    want = ref_gpt.forward(p, cfg["gpt"], code, exact)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())


def test_training_steps(small_config):
    """Three steps of the port's trainer and of the reference from the same
    weights and codes: each loss, each leaf's first gradient (from AdamW's
    first moment) and its change over the steps."""
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    from ccvs_bench.entries.gpt_train import _torch_optimizer

    cfg = small_config("bairhd")
    pcfg, ae, _, _, p = port_models(cfg)
    trainer = TransformerTrainer(pcfg, ae, dtype=torch.float32, device="cpu")
    gpt = trainer.transformer.model
    gpt.load_state_dict(p, strict=True)
    state = trainer.init_state()
    names = {id(v): k for k, v in gpt.named_parameters()}
    batches, losses = [], []
    for i in range(3):
        tokens = trainer.encode_batch({"vid": clips(cfg, 4, 4, seed=10 + i)})
        batches.append(tokens["code"])
        state, metrics = trainer.step(state, tokens)
        losses.append(float(metrics["nll"]))
        if i == 0:
            opt = _torch_optimizer(state)
            g1 = {names[id(v)]: float(opt.state[v]["exp_avg"].norm()) / 0.1
                  for grp in opt.param_groups for v in grp["params"]}
    ref = {k: v.clone() for k, v in p.items()}
    ref_losses, ref_g1 = ref_gpt.train_steps(ref, cfg["gpt"], batches, exact, micro=2)
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    keep = [k for k, v in ref_g1.items() if v >= 1e-3 * sorted(ref_g1.values())[len(ref_g1) // 2]]
    assert len(keep) < len(ref_g1)  # the keys' biases: no gradient under softmax
    assert common.worst_leaf_gap(g1, ref_g1, keep) < 1e-4
    change = {k: float((v.detach() - p[k]).norm()) for k, v in gpt.named_parameters()}
    ref_change = {k: float((ref[k] - p[k]).norm()) for k in p}
    assert common.worst_leaf_gap(change, ref_change, keep) < 1e-4


def test_topk_rule(small_config):
    """Every token the port's sampler draws lies at or above the ``top_k``-th
    logit, the bound ``topk_gap`` reads against."""
    from ccvs_tpu_torch.models.transformer import KIND_FRAME, _sample_token
    from ccvs_tpu_torch.config import TransformerConfig

    gpt = small_config("bairhd")["gpt"]
    tcfg = dataclasses.replace(TransformerConfig(), z_num=gpt["z_num"], top_k=gpt["top_k"])
    logits = torch.randn(64, gpt["z_num"], generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    for _ in range(20):
        tok = _sample_token(tcfg, g, logits, KIND_FRAME)
        chosen = logits.gather(1, tok[:, None])[:, 0]
        assert bool((chosen >= ref_gpt.kth_logit(logits, gpt["top_k"])).all())
