"""The autoencoder trainers of ccvs_tpu_torch, their weights and their CLI, on
the CPU: fp32 master parameters under bf16 compute against the JAX
package's one Adam step, the STFT autoencoder's step against ccvs_tpu's,
the autoencoder export loaded into ccvs_tpu, the discriminators' and VGG's
trees, ``FoldCycler``, and ``FrameAutoencoderTrainer`` /
``StftAutoencoderTrainer`` runs, resume and SIGTERM, and ``cli.py``'s
``train-ae`` -> ``train-transformer`` / ``train-state``. Each test states
its tolerance."""

import dataclasses
import importlib.util
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ccvs_tpu import config as jcfg
from ccvs_tpu.data import FoldCycler as JFoldCycler
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import StftModel as JStft
from ccvs_tpu.nn import discriminators as jdisc
from ccvs_tpu.nn import vgg as jvgg
from ccvs_tpu.port.npz_params import flatten_params, unflatten_params
from ccvs_tpu.train import states as jstates
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu.train.ae_losses import AELosses as JLosses
from ccvs_tpu_torch import cli
from ccvs_tpu_torch.config import AutoencoderConfig, Config, DataConfig, StftConfig
from ccvs_tpu_torch.config import StateConfig, TransformerConfig
from ccvs_tpu_torch.data import FoldCycler
from ccvs_tpu_torch.models import FrameAutoencoder, StftModel
from ccvs_tpu_torch.nn import discriminators as tdisc
from ccvs_tpu_torch.nn import vgg as tvgg
from ccvs_tpu_torch.train import states as tstates
from ccvs_tpu_torch.train import steps as tsteps
from ccvs_tpu_torch.train.ae_losses import AELosses
from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, load_ae_checkpoint
from ccvs_tpu_torch.train.state_trainer import StftAutoencoderTrainer
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from ccvs_tpu_torch.weights import export_params, load_params
from test_torch_ae_train import AE as TRAIN_AE
from test_torch_ae_train import batches, jax_models, port_models, port_tree, vgg_tree
from test_torch_train import assert_adam_close, close, largest
from test_train import AE_CFG
from torch_parity import (AE, REPO, fast_jit, few_threads, jax_params, load_into, port_config,
                          set_fp32, to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------- fp32 master parameters ----------------


def test_fp32_parameters_under_bf16_compute_take_jax_adam_step():
    """A bf16-compute autoencoder holding fp32 parameters takes one Adam
    step at the AE's lr 2e-3 (``beta1 = 0``: each parameter moves by about
    ``lr * sign(g)``) as the JAX package's does: the gradients within 2e-2
    of the largest (bf16 compute on both sides, rounded in another order),
    the update equal within four fp32 spacings of its operands (each side
    rounds the quotient, the product and the sum) wherever the JAX gradient
    is above that tolerance, and at most ``2 lr`` off
    elsewhere. Every weight takes the update of its own gradient; with bf16
    parameters most would not: bf16's spacing is 3.9e-3 on [0.5, 1) and
    7.8e-3 on [1, 2), so such a weight moves by a whole spacing or not at
    all."""
    cfg = dataclasses.replace(AE_CFG, use_di=False, use_dv=False)
    jae = JAE(cfg, dtype=jnp.bfloat16)
    jlosses = JLosses(cfg, jae)
    gen = jax_params(jae.init, seed=21)
    rng = np.random.RandomState(22)
    batch = {"img": (rng.randn(6, 8, 8, 3) * 0.3).astype(np.float32),
             "flow_img": rng.randn(2, 8, 8, 2).astype(np.float32),
             "mask_img": (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)}
    jopt, _ = jstates.make_ae_optimizers(cfg)

    def jstep(g, b):
        (_, m), grad = jax.value_and_grad(
            lambda p: jlosses.img_generator_loss(p, None, None, b, None), has_aux=True)(g)
        upd, _ = jopt.update(grad, jopt.init(g), g)
        return optax.apply_updates(g, upd), grad, m[0]

    jnew, jgrad, _ = fast_jit(jstep)(gen, {k: jnp.asarray(v) for k, v in batch.items()})
    moved = {}
    for pdt in (torch.float32, torch.bfloat16):
        ae = FrameAutoencoder(port_config(cfg), dtype=torch.bfloat16, device="cpu",
                              param_dtype=pdt)
        load_into(ae, gen)
        assert {p.dtype for n, p in ae.named_parameters() if "quantizer" not in n} == {pdt}
        start = {n: p.detach().float().clone() for n, p in ae.named_parameters()}
        init, g_step, _, _ = tsteps.make_ae_steps(AELosses(port_config(cfg), ae))
        state, m, _ = g_step(init(), {k: torch.from_numpy(v) for k, v in batch.items()}, "img")
        assert m["g_loss"].dtype == torch.float32 and torch.isfinite(m["g_loss"])
        # the share of weights that took Adam's first update of their own
        # gradient, -lr g / (|g| + 1e-8), within 1 %
        took = []
        for n, p in ae.named_parameters():
            if n.endswith("weight"):
                g = p.grad.float()
                want = -cfg.lr * g / (g.abs() + 1e-8)
                took.append(((p.detach().float() - start[n] - want).abs()
                             <= 1e-2 * want.abs() + 1e-12).float().mean())
        moved[pdt] = float(torch.stack(took).mean())
        if pdt == torch.bfloat16:
            continue
        want_g = port_tree(ae, jgrad)
        want_p = port_tree(ae, jnew)
        scale = largest(want_g.values())
        for n, p in ae.named_parameters():
            close(p.grad.float(), want_g[n], rtol=0.0, rel_atol=2e-2, scale=scale, what=n)
            d_got, d_want = (p.detach() - start[n]).double(), (want_p[n] - start[n]).double()
            # rounding of the operands: the parameter before and after, and the update
            mag = np.maximum(np.abs(to_np(want_p[n])), np.abs(to_np(start[n])))
            ulps = 4 * (np.spacing(mag.astype(np.float32)) + np.spacing(np.float32(cfg.lr)))
            loose = (want_g[n].abs() <= 2e-2 * scale).double().numpy()
            bound = np.where(loose, 2 * cfg.lr, ulps)
            assert float(((d_got - d_want).abs().numpy() - bound).max()) <= 0, n
    assert moved[torch.float32] > 0.99, moved
    assert moved[torch.bfloat16] < 0.5, moved


class _Count(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _Count.n += 1
        return func(*args, **(kwargs or {}))


def test_serving_keeps_bf16_parameters_and_its_operation_count():
    """Serving's default holds bf16 parameters, so the repair's casts are
    skipped: a bf16 ``decode_frame`` against a 3-slot FIFO dispatches 1906
    PyTorch operations and an encode 160 on the CPU at ``torch_parity.AE``,
    the counts before the repair (the decode's 1914 then, less 8 no-op
    stride-1 slices that ``Matching`` no longer makes at its unstrided
    resolutions)."""
    ae = FrameAutoencoder(port_config(AE), dtype=torch.bfloat16, device="cpu").init(0)
    assert {p.dtype for n, p in ae.named_parameters() if "quantizer" not in n} == {
        torch.bfloat16}
    fifo, mask = ae._zero_inters(2, 3), ae.fifo_mask(2, 2)
    z, frames = torch.zeros(2, 4, 4, 16), torch.zeros(2, 32, 32, 3)
    counts = []
    with torch.no_grad():
        for fn in (lambda: ae.decode_frame(z, fifo, mask), lambda: ae.encode(frames)):
            _Count.n = 0
            with _Count():
                fn()
            counts.append(_Count.n)
    assert counts == [1906, 160]


# ---------------- the perceptual term ----------------


def test_img_generator_loss_with_vgg_matches_ccvs_tpu():
    """The image generator loss with the perceptual term, at 16 px (8x8
    latents: VGG19's fourth pooling needs 16 px), and the inter-feature
    reconstruction (without the corruption split, as the JAX loss takes
    it): its metrics within rtol 1e-5 and the gradient of every parameter
    within rtol 1e-4 plus 1e-5 of the largest."""
    cfg = dataclasses.replace(TRAIN_AE, max_dim=16, z_shape=(8, 8), use_vgg_img=True,
                              use_inter_rec_loss_img=True, elastic_corruption=False,
                              use_df=False)
    jlosses, gen, disc = jax_models(cfg)
    vgg = vgg_tree(3)
    bi, _ = batches(0, h=16)

    def f(g, b):
        loss, (m, _) = jlosses.img_generator_loss(g, disc, vgg, b, None)
        return loss, m

    (jl_, jm), jgrad = fast_jit(jax.value_and_grad(f, has_aux=True))(
        gen, {k: jnp.asarray(v) for k, v in bi.items()})
    losses = port_models(cfg, gen, disc, vgg)
    loss, (m, _) = losses.img_generator_loss({k: torch.from_numpy(v) for k, v in bi.items()})
    loss.backward(inputs=list(losses.ae.parameters()))
    assert {"vgg_img", "inter_rec_img"} <= set(m) and set(m) == set(jm)
    for k in jm:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5), k
    want = port_tree(losses.ae, jgrad)
    scale = largest(want.values())
    for n, p in losses.ae.named_parameters():
        close(p.grad, want[n], rtol=1e-4, rel_atol=1e-5, scale=scale, what=n)
    assert all(p.grad is None for p in losses.di.parameters())


# ---------------- weights ----------------


def test_discriminator_and_vgg_trees_are_ccvs_tpu_trees():
    """The port's discriminators and VGG hold the JAX package's trees, key
    for key and shape for shape (``weights.load_params`` carries them, as
    the step tests of ``test_torch_ae_train.py`` load them)."""
    cfg = AE_CFG
    h = cfg.max_dim
    shapes = jax.eval_shape(lambda k: {
        "di": jdisc.ImageDiscriminator(cfg).init(k, jnp.zeros((2, h, h, 3)))["params"],
        "dv": jdisc.VideoDiscriminator(cfg, vid_len=cfg.vid_len).init(
            k, jnp.zeros((2, cfg.vid_len, h, h, 3)))["params"],
        "df": jdisc.FeatureDiscriminator(cfg).init(
            k, jnp.zeros((4, *cfg.z_shape, cfg.z_size)))["params"]}, jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in flatten_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
        dtype=None).items()}
    pcfg = port_config(cfg)
    ds = torch.nn.ModuleDict({"di": tdisc.ImageDiscriminator(pcfg),
                              "dv": tdisc.VideoDiscriminator(pcfg, pcfg.vid_len),
                              "df": tdisc.FeatureDiscriminator(pcfg)})
    assert {k: v.shape for k, v in export_params(ds).items()} == want
    for arch in ("vgg19", "vgg16"):
        tree = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(lambda k: jvgg.init_random(k, arch), jax.random.PRNGKey(0)))
        v = load_into(tvgg.VGG(arch), tree)
        assert {k: v.shape for k, v in export_params(v).items()} == {
            k: v.shape for k, v in flatten_params(tree, dtype=None).items()}


def test_ae_export_loads_into_ccvs_tpu_and_encodes_the_same_codes():
    """The raw generator and the EMA of a port train state, exported in the
    JAX keys (``export_params``), rebuild the JAX ``ae_gen`` tree; the JAX
    encode on them gives the port's codes."""
    cfg = jcfg.AutoencoderConfig(**{f.name: getattr(AE_CFG, f.name)
                                    for f in dataclasses.fields(AE_CFG)})
    cfg = dataclasses.replace(cfg, max_dim=16, z_shape=(8, 8), use_dv=False)
    jlosses, gen, disc = jax_models(cfg)
    losses = port_models(cfg, gen, disc)
    init, g_step, _, _ = tsteps.make_ae_steps(losses)
    rng = np.random.RandomState(23)
    batch = {"img": torch.from_numpy((rng.randn(6, 16, 16, 3) * 0.3).astype(np.float32))}
    state, _, _ = g_step(init(), batch, "img")
    frames = (rng.rand(3, 16, 16, 3) * 2 - 1).astype(np.float32)
    enc = fast_jit(lambda p, x: jlosses.ae.encode(p, x)["code"])
    for module in (state.gen, state.ema):
        flat = export_params(module)
        assert set(flat) == set(flatten_params(gen, dtype=None))
        tree = jax.tree_util.tree_map(jnp.asarray, unflatten_params(flat))
        want = np.asarray(enc(tree, frames))
        got = to_np(module.encode(torch.from_numpy(frames))["code"])
        np.testing.assert_array_equal(got, want)
    assert not all(torch.equal(a, b) for a, b in zip(state.gen.parameters(),
                                                     state.ema.parameters()))


# ---------------- data ----------------


@pytest.mark.parametrize("random_fold", [False, True])
def test_fold_cycler_matches_ccvs_tpu(random_fold):
    """The folds visited, loader by loader: round robin from ``init_fold``
    or drawn from the seeded generator."""
    def visits(cls):
        seen = []

        def make(fold):
            seen.append(fold)
            return [fold] * 2

        it = iter(cls(make, 5, init_fold=3, random_fold=random_fold, seed=7))
        return [next(it) for _ in range(14)], seen

    assert visits(FoldCycler) == visits(JFoldCycler)


# ---------------- the STFT autoencoder ----------------


def test_stft_step_matches_ccvs_tpu():
    """Three Adam steps of the STFT autoencoder with the perceptual loss:
    the metrics of every step within rtol 1e-5, the first step's gradients
    within rtol 1e-4 plus 1e-4 of the largest (sums through VGG's 512
    channels) and its parameters within
    ``assert_adam_close``'s bound. That bound reads the first gradient; a
    later step's update of an entry whose gradient has since fallen to
    rounding level is ``lr m / sqrt(v)`` of noise, so later parameters are
    held through the metrics they give."""
    scfg = jcfg.StftConfig(stft_size=16, stft_shape=(8, 2), stft_num=32)
    jm = JStft(scfg)
    params = jax_params(jm.init, seed=24)
    tree = vgg_tree(25)
    s = scfg
    jinit, jstep = jsteps.make_simple_step(
        lambda p, b: jm.loss(p, b["stft"].reshape(-1, 64, 16, 1),
                             vgg_fn=lambda a, c: jvgg.vgg_loss(tree, a, c)),
        jstates.make_adam(s.lr, s.beta1, s.beta2, s.weight_decay))
    jstep = fast_jit(jstep.__wrapped__)  # make_simple_step's step, quick compile
    jstate = jinit(params)
    model = load_into(StftModel(port_config(scfg), device="cpu"), params)
    vgg = load_into(tvgg.VGG(), tree)
    tinit, tstep = tsteps.make_simple_step(
        lambda m, b: m.loss(b["stft"].reshape(-1, 64, 16, 1), vgg),
        lambda m: tstates.make_adam(m.parameters(), s.lr, s.beta1, s.beta2, s.weight_decay))
    tstate = tinit(model)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.RandomState(26)
    for i in range(3):
        batch = {"stft": rng.uniform(-1, 1, (2, 3, 64, 16, 1)).astype(np.float32)}
        jstate, jmet = jstep(jstate, {"stft": jnp.asarray(batch["stft"])})
        tstate, tmet = tstep(tstate, {"stft": torch.from_numpy(batch["stft"])})
        assert set(tmet) == set(jmet)
        for k in jmet:
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5), (i, k)
        if i == 0:
            # beta1 0.5: the first moment after one step is half the gradient
            jgrad = port_tree(model, jax.tree_util.tree_map(lambda m: m * 2, jstate.opt[0].mu))
            scale = largest(jgrad.values())
            want = port_tree(model, jstate.params)
            for n, p in model.named_parameters():
                close(p.grad, jgrad[n], rtol=1e-4, rel_atol=1e-4, scale=scale, what=n)
                assert_adam_close(p, want[n], start[n], p.grad, s.lr, 1, scale)


# ---------------- the trainers ----------------


def _ae_config(tmp_path, **over):
    ae = AutoencoderConfig(
        necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32, z_shape=(8, 8),
        max_dim=16, inter_p=0.5, skip_memory=2, skip_context=(1, 2), use_dv=True,
        use_vgg_img=True, use_direct_recovery_vid=True, slide_inter=True, n_consecutive_img=2,
        vid_len=2, load_elastic_view=True, elastic_corruption=True,
        use_elastic_flow_recovery=True, d_reg_every=2, stddev_group=2)
    data = DataConfig(dataset="synthetic", max_dim=16, true_dim=32, vid_len=2, batch_size_img=6,
                      batch_size_vid=2, n_consecutive_img=2, img_out_of_n=8, num_workers=1,
                      load_elastic_view=True, elastic_corruption=True, elastic_alpha=1.0,
                      elastic_sigma=0.2)
    gpt = TransformerConfig(z_num=32, z_len=128, z_chunk=64, num_blocks=2, cond_len=64,
                            n_layer=2, n_head=2, n_embd=32, z_shape=(8, 8))
    cfg = Config(name="ae_tiny", data=data, ae=dataclasses.replace(ae, **over), gpt=gpt,
                 save_path=str(tmp_path), n_iter=3, save_latest_freq=2, log_freq=None,
                 npz_mirror=str(tmp_path / "mirror.npz"))
    return cfg


def _metrics(tmp_path, name):
    with open(tmp_path / "logs" / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_ae_trainer_runs_evaluates_and_resumes(tmp_path):
    """Three iterations with the eval every 2 (the EMA's and the raw
    generator's PSNR), R1 every 2, checkpoints, the npz mirror in the JAX
    package's ``ae_gen`` keys, then a resume to 5 that continues the count
    and the optimizers."""
    cfg = _ae_config(tmp_path)
    tr = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    state = tr.run(eval_every=2)
    assert state.step == 3 and state.opt_g.count == 6 and not tr.preempted
    keys = {k for d in _metrics(tmp_path, "ae_tiny") for k in d}
    assert {"qvid_generator/g_loss", "qvid_generator/d_loss", "qvid_generator/r1_img",
            "qvid_generator/r1_vid", "qvid_generator/vgg_img", "qvid_generator/gen_vid",
            "qvid_eval/rec_psnr", "qvid_eval/rec_psnr_raw"} <= keys
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "ae_tiny"))
    saved = ck.load("qvid", "latest")
    assert saved["step"] == 3 and saved["opt_g"]["count"] == 6
    jae = JAE(jcfg.AutoencoderConfig(**{f.name: getattr(cfg.ae, f.name) for f in
                                        dataclasses.fields(jcfg.AutoencoderConfig)
                                        if hasattr(cfg.ae, f.name)}))
    want = flatten_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(jae.init, jax.random.PRNGKey(0))), dtype=None)
    with np.load(cfg.npz_mirror) as z:
        assert {k: z[k].shape for k in z.files} == {"ae_gen/" + k: v.shape
                                                     for k, v in want.items()}
        close(z["ae_gen/quantizer/embedding"], state.gen.quantizer.embedding, rtol=1e-3)
    again = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    resumed = again.run(n_iter=5, resume=True)
    assert resumed.step == 5 and resumed.opt_g.count == 10
    assert max(d["step"] for d in _metrics(tmp_path, "ae_tiny")) == 4
    ema = load_ae_checkpoint(str(tmp_path / "checkpoints" / "ae_tiny"), dtype=torch.float32,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(ema.parameters(), resumed.ema.parameters()))


def test_resumed_ae_run_draws_what_an_uninterrupted_run_draws(tmp_path):
    """With ``inter_drop_p > 0`` every iteration draws context-drop masks.
    Iteration 2's generator, before and after its draws, is the same in an
    uninterrupted run of 3 iterations and in a run resumed at 2: each
    iteration's generator comes from ``(seed, it)``."""
    seen = {}

    def run(name, n_iter, resume=False):
        cfg = _ae_config(tmp_path, inter_drop_p=0.5).replace(name=name, npz_mirror="",
                                                              save_latest_freq=100)
        tr = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
        iteration = tr.iteration

        def recording(state, it, img, vid=None, generator=None):
            before = generator.get_state().clone()
            out = iteration(state, it, img, vid, generator)
            seen[name, it] = before, generator.get_state().clone()
            return out

        tr.iteration = recording
        tr.run(n_iter=n_iter, resume=resume)

    run("whole", 3)
    run("cut", 2)
    run("cut", 3, resume=True)
    for it in range(3):
        before, after = seen["whole", it]
        assert not torch.equal(before, after), f"iteration {it} drew nothing"
        assert torch.equal(before, seen["cut", it][0]) and torch.equal(after, seen["cut", it][1])


def test_ae_trainer_checkpoints_on_sigterm(tmp_path):
    cfg = _ae_config(tmp_path).replace(n_iter=6, npz_mirror="")
    trainer = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    iteration = trainer.iteration

    def iteration_then_signal(state, it, *args, **kw):
        out = iteration(state, it, *args, **kw)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.iteration = iteration_then_signal
    state = trainer.run()
    assert trainer.preempted and state.step == 2
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "ae_tiny"))
    assert ck.step_of("qvid") == 2 and ck.load("qvid", "latest")["step"] == 2


def test_ae_trainer_fold_cycler_and_unported_options(tmp_path):
    cfg = _ae_config(tmp_path)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_folds_train=3,
                                               random_fold_train=True))
    img_loader, vid_loader = FrameAutoencoderTrainer(
        cfg, dtype=torch.float32, device="cpu").make_loaders()
    assert isinstance(img_loader, FoldCycler) and vid_loader.batch_size == 2
    assert next(iter(img_loader))["img"].shape == (6, 16, 16, 3)
    # the options once refused build now: the layout twins and ADA
    # (tests/test_torch_layouts.py and tests/test_torch_ada.py hold them)
    tr = FrameAutoencoderTrainer(_ae_config(tmp_path, use_layout=True, layout_size=2),
                                 device="cpu")
    assert tr.ae.encoder_l is not None and tr.ae.decoder_l is not None
    tr = FrameAutoencoderTrainer(_ae_config(tmp_path, use_aug=True), device="cpu")
    assert float(tr.init_state().ada_p) == 0.0


def test_stft_trainer_runs_and_resumes(tmp_path):
    cfg = _ae_config(tmp_path).replace(name="stft_tiny", stft=StftConfig(stft_num=32),
                                       n_iter_eval=1, npz_mirror=str(tmp_path / "s.npz"))
    rng = np.random.RandomState(27)
    data = [{"stft": rng.uniform(-1, 1, (2, 2, 64, 16, 1)).astype(np.float32)}
            for _ in range(3)]
    tr = StftAutoencoderTrainer(cfg, device="cpu")
    tr.make_loader = lambda: data
    state = tr.run(n_iter=3)
    assert state.step == 3
    keys = {k for d in _metrics(tmp_path, "stft_tiny") for k in d}
    assert {"stft/stft_mse", "stft/stft_quant", "stft/stft_perp", "stft/stft_vgg"} <= keys
    ck = CheckpointManager(str(tmp_path / "checkpoints" / "stft_tiny"))
    assert ck.best_metric("stft") < float("inf")
    with np.load(cfg.npz_mirror) as z:
        assert set(z.files) == {"stft/" + k for k in export_params(state.params)}
    tr2 = StftAutoencoderTrainer(cfg, device="cpu")
    tr2.make_loader = lambda: data
    assert tr2.run(n_iter=4, resume=True).step == 4


def test_cli_train_ae_then_the_latent_stage(tmp_path):
    """``train-ae``, then ``train-transformer`` and ``train-state`` on its
    checkpoint (EMA weights by default, the raw generator's with
    ``--ae-raw``)."""
    cfg = _ae_config(tmp_path).replace(n_iter=2, npz_mirror="")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, load_state=True),
                      state=StateConfig(z_size=16, z_shape=(8, 8), state_hsize=8, state_size=2,
                                        state_num=8))
    path = tmp_path / "config.json"
    path.write_text(cfg.to_json())
    common = ["--load-config", str(path), "--device", "cpu", "--dtype", "float32"]
    cli.main(["train-ae", *common])
    ae_dir = str(tmp_path / "checkpoints" / "ae_tiny")
    assert CheckpointManager(ae_dir).step_of("qvid") == 2
    cli.main(["train-transformer", *common, "--name", "gpt", "--ae-ckpt", ae_dir])
    assert CheckpointManager(str(tmp_path / "checkpoints" / "gpt")).step_of("transformer") == 2
    state_cfg = cfg.replace(data=dataclasses.replace(cfg.data, n_consecutive_img=1,
                                                     load_elastic_view=False,
                                                     elastic_corruption=False))
    spath = tmp_path / "state_config.json"
    spath.write_text(state_cfg.to_json())
    cli.main(["train-state", "--load-config", str(spath), "--device", "cpu", "--name", "st",
              "--ae-ckpt", ae_dir, "--ae-raw"])
    assert CheckpointManager(str(tmp_path / "checkpoints" / "st")).step_of("state") == 2
    raw = load_ae_checkpoint(ae_dir, raw=True, device="cpu")
    ema = load_ae_checkpoint(ae_dir, device="cpu")
    assert raw.dtype == torch.bfloat16 and not all(
        torch.equal(a, b) for a, b in zip(raw.parameters(), ema.parameters()))


def test_chip_smoke_ae_mirror_keys_are_ccvs_tpu_keys():
    """``chip_smoke.py`` (on a machine without JAX) checks the AE trainer's
    npz mirror against a committed key list; that list is the JAX package's
    ``ae_gen`` tree of the same configuration."""
    cs = _chip_smoke()
    acfg = cs.small_ae_config().ae
    jae = JAE(jcfg.AutoencoderConfig(**{f.name: getattr(acfg, f.name) for f in
                                        dataclasses.fields(jcfg.AutoencoderConfig)
                                        if hasattr(acfg, f.name)}))
    shapes = jax.eval_shape(jae.init, jax.random.PRNGKey(0))
    want = flatten_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                          dtype=None)
    assert {k: tuple(v.shape) for k, v in want.items()} == cs.AE_MIRROR_KEYS
