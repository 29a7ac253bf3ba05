"""Adaptive discriminator augmentation (ADA) in ccvs_tpu_torch against
ccvs_tpu, on the CPU in fp32: the samplers' matrices from the JAX package's
own draws, the warp, the colour matrix and ``augment`` on given draws, the
first and second derivatives through the augmentation (R1's), the bilinear
sample's double backward (``gradgradcheck``), three iterations of the
image steps of ``make_ae_steps`` with ADA (metrics, gradients, R1 through
the augmentation, the controller's ``ada_p`` / ``ada_rt``), a resumed run
continuing ``ada_p``, and one iteration of each trained configuration of
``runs_r5/``.

The JAX draws: ``jax.random`` under the key splits of
``ccvs_tpu/train/ada.py`` (:func:`jax_draws`), fed to the port's
``build_affine`` / ``build_color``. In the steps, the port's ``aug_fn``
applies the draws that the JAX package's ``augment`` makes at the same
place (G step: ``fold_in(rng, 1)``; D step: ``fold_in(rng, 2)``, salts 0
and 1; R1: ``fold_in(rng, 3)``). Each test states its tolerance."""

import dataclasses
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvs_tpu.train import ada as jada
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu_torch.config import Config
from ccvs_tpu_torch.ops.warp import bilinear_sample
from ccvs_tpu_torch.train import ada as tada
from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer, to_device
from ccvs_tpu_torch.train.states import iteration_generator
from ccvs_tpu_torch.train.steps import make_ae_steps
from ccvs_tpu_torch.weights import load_params
from ccvs_tpu.port.npz_params import flatten_params
from test_torch_ae_train import _grads, jax_models, port_models, port_tree
from test_torch_train import close, largest
from test_train import AE_CFG
from torch_parity import REPO, fast_jit, few_threads, set_fp32, to_np

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")


def _raw_draws(key, b):
    k1, k2 = jax.random.split(key)
    ka, kc = jax.random.split(k1, 16), jax.random.split(k2, 10)

    def u(k, lo, hi):
        return jax.random.uniform(k, (b,), minval=lo, maxval=hi)

    def sel(ks, idx):
        return jnp.stack([jax.random.uniform(ks[i], (b, 1, 1)).reshape(b) for i in idx])

    aff = {"flip": jax.random.randint(ka[0], (b,), 0, 2),
           "rot90": jax.random.randint(ka[2], (b,), 0, 2),
           "translate": u(ka[4], -0.125, 0.125), "iso": jax.random.normal(ka[6], (b,)),
           "pre_rot": u(ka[8], -math.pi, math.pi), "aniso": jax.random.normal(ka[10], (b,)),
           "post_rot": u(ka[12], -math.pi, math.pi), "frac": jax.random.normal(ka[14], (b,)),
           "sel": sel(ka, range(1, 16, 2))}
    col = {"brightness": jax.random.normal(kc[0], (b,)),
           "contrast": jax.random.normal(kc[2], (b,)),
           "luma_flip": jax.random.randint(kc[4], (b,), 0, 2), "hue": u(kc[6], -math.pi, math.pi),
           "saturation": jax.random.normal(kc[8], (b,)), "sel": sel(kc, range(1, 10, 2))}
    return aff, col


_RAW_DRAWS = {}


def jax_draws(key, b):
    """The raw numbers that ``ccvs_tpu``'s ``augment(key, ...)`` draws for
    ``b`` images, as the port's ``(affine, colour)`` draw dicts: the same
    ``jax.random`` calls on the same key splits (``bernoulli`` is a uniform
    compared with ``p``), under one ``jax.jit`` a batch size."""
    if b not in _RAW_DRAWS:
        _RAW_DRAWS[b] = jax.jit(lambda k: _raw_draws(k, b))
    return tuple({k: torch.tensor(np.asarray(v, np.float32)) for k, v in d.items()}
                 for d in _RAW_DRAWS[b](key))


@pytest.mark.parametrize("p", [0.3, 1.0])
def test_samplers_build_the_jax_packages_matrices(p):
    """From the JAX package's draws, ``build_affine`` / ``build_color``
    give its ``sample_affine`` / ``sample_color`` within 1e-6 (fp32
    rounding of ``exp``, ``cos`` and the 3x3 / 4x4 products); ``p`` a
    number or a tensor alike. At ``p = 0.3`` some transforms are skipped,
    at 1 none (the rotations at ``1 - sqrt(1 - p)``)."""
    b, h, w = 64, 16, 24
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    aff, col = jax_draws(key, b)
    want_g = np.asarray(fast_jit(lambda k, pp: jada.sample_affine(k, pp, b, h, w))(
        k1, jnp.float32(p)))
    want_c = np.asarray(fast_jit(lambda k, pp: jada.sample_color(k, pp, b))(k2, jnp.float32(p)))
    for pp in (p, torch.tensor(p)):
        np.testing.assert_allclose(to_np(tada.build_affine(aff, pp, h, w)), want_g, atol=1e-6)
        np.testing.assert_allclose(to_np(tada.build_color(col, pp)), want_c, atol=1e-6)
    skipped = (aff["sel"] >= p).any().item()
    assert skipped == (p < 1)
    # the port's own draws: shapes, ranges, a stream of the generator
    g = torch.Generator().manual_seed(0)
    d = tada.draw_affine(g, b)
    assert set(d) == set(aff) and d["sel"].shape == (8, b) and set(d["flip"].tolist()) <= {0, 1}
    assert set(tada.draw_color(g, b)) == set(col)
    assert tada.sample_affine(g, p, b, h, w).shape == (b, 3, 3)
    assert tada.sample_color(g, p, b).shape == (b, 4, 4)


@pytest.mark.parametrize("size", [(16, 16), (13, 19)])
def test_warp_colour_and_augment_match_ccvs_tpu(size):
    """On the same matrices, ``apply_affine`` (the reflect pad, the sym6 up-
    and downsampling, the bilinear sample) and ``apply_color`` within
    1e-5; ``augment`` on the JAX package's draws within 1e-5; square and
    odd non-square images, output shape the input's."""
    h, w = size
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (3, h, w, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    G = np.linalg.inv(np.asarray(fast_jit(lambda k: jada.sample_affine(k, 0.9, 3, h, w))(k1)))
    C = np.asarray(fast_jit(lambda k: jada.sample_color(k, 0.9, 3))(k2))
    want = np.asarray(fast_jit(jada.apply_affine)(jnp.asarray(img), jnp.asarray(G)))
    got = to_np(tada.apply_affine(torch.from_numpy(img), torch.from_numpy(G)))
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(to_np(tada.apply_color(torch.from_numpy(img), torch.from_numpy(C))),
                               np.asarray(fast_jit(jada.apply_color)(jnp.asarray(img),
                                                                     jnp.asarray(C))),
                               atol=1e-5)
    want = np.asarray(fast_jit(lambda k, x: jada.augment(k, x, jnp.float32(0.9)))(
        key, jnp.asarray(img)))
    got = to_np(tada.augment(None, torch.from_numpy(img), 0.9, draws=jax_draws(key, 3)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_first_and_second_derivatives_match_jax():
    """R1 through the augmentation: for a small discriminator ``D(x) =
    sum(softplus(aug(x) * v))``, the input gradient of D (first
    derivative) and the gradient of ``||grad_x D||^2`` with respect to
    ``v`` (a second derivative through the warp, R1's) against ``jax.grad``
    of ``jax.grad``, within 1e-5 of the largest entry."""
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2, 12, 12, 3)).astype(np.float32)
    v0 = rng.normal(0, 1, (1, 12, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    draws = jax_draws(key, 2)

    def jd(v, x):
        return jnp.sum(jax.nn.softplus(jada.augment(key, x, jnp.float32(0.8)) * v))

    def jr1(v, x):
        return jnp.sum(jax.grad(jd, argnums=1)(v, x) ** 2)

    want_g = np.asarray(fast_jit(jax.grad(jd, argnums=1))(jnp.asarray(v0), jnp.asarray(img)))
    want_r = np.asarray(fast_jit(jax.grad(jr1))(jnp.asarray(v0), jnp.asarray(img)))
    v = torch.from_numpy(v0).requires_grad_()
    x = torch.from_numpy(img).requires_grad_()
    d = torch.nn.functional.softplus(tada.augment(None, x, 0.8, draws=draws) * v).sum()
    (gx,) = torch.autograd.grad(d, x, create_graph=True)
    (gv,) = torch.autograd.grad((gx ** 2).sum(), v)
    close(gx.detach(), want_g, rtol=1e-5, rel_atol=1e-5)
    close(gv, want_r, rtol=1e-5, rel_atol=1e-5)


def test_bilinear_sample_is_differentiable_twice():
    """``bilinear_sample`` in float64: ``F.grid_sample``'s values (grid
    partly outside the image), and ``gradcheck`` / ``gradgradcheck`` of it
    alone and inside a nonlinear function."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 3, dtype=torch.float64, generator=g, requires_grad=True)
    grid = torch.rand(2, 4, 7, 2, dtype=torch.float64, generator=g) * 2.4 - 1.2
    want = torch.nn.functional.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=False)
    torch.testing.assert_close(bilinear_sample(x, grid), want.permute(0, 2, 3, 1))
    for fn in (lambda t: bilinear_sample(t, grid),
               lambda t: torch.sin(bilinear_sample(t * t, grid))):
        assert torch.autograd.gradcheck(fn, (x,))
        assert torch.autograd.gradgradcheck(fn, (x,))


# ---------------- make_ae_steps with ADA ----------------

# ``aug_p = 0`` is the adaptive probability; the target below any
# ``mean(sign(D(real)))`` raises p by 4 / 10 each image D step (4 real
# images): 0, 0.4, 0.8, then clipped at 1
AE = dataclasses.replace(AE_CFG, use_aug=True, aug_p=0.0, ada_target=-1.5, ada_length=10)
ITERS = 3
SITES = {"g": [(1, 0)], "d": [(2, 0), (2, 1)], "r1": [(3, 0)]}


class JaxDrawsAug:
    """The port's ``aug_fn`` for the steps: ``augment`` on the JAX
    package's draws of each place the step augments, in the order the step
    calls them (:meth:`load`)."""

    def __init__(self):
        self.queue = []

    def load(self, key, kind, b):
        self.queue = [jax_draws(jax.random.fold_in(jax.random.fold_in(key, site), salt), b)
                      for site, salt in SITES[kind]]

    def __call__(self, generator, img, p):
        return tada.augment(generator, img, p, draws=self.queue.pop(0))


@pytest.fixture(scope="module")
def ada_runs():
    """The image G, D and R1 steps of three iterations (R1 at 0 and 2) with
    ADA in both packages. The port runs them twice, free and synced (taking
    the JAX parameters and ``ada_p`` before every step); recorded after
    every step: both packages' metrics, gradients, ``ada_p`` and
    ``ada_rt``."""
    jlosses, gen, disc = jax_models(AE)
    jinit, jg, jd, jr = jsteps.make_ae_steps(jlosses, None, aug_fn=jada.augment)
    jfn = {"g": fast_jit(lambda s, b, r: jg(s, b, r, "img")),
           "d": fast_jit(lambda s, b, f, r: jd(s, b, f, r, "img")),
           "r1": fast_jit(lambda s, b, r: jr(s, b, "img", rng=r))}
    runs = {}
    for name in ("free", "synced"):
        aug = JaxDrawsAug()
        init, *steps = make_ae_steps(port_models(AE, gen, disc), aug_fn=aug)
        runs[name] = {"aug": aug, "state": init(), "steps": dict(zip(("g", "d", "r1"), steps))}
    jstate = jinit(jax.random.PRNGKey(0), gen, disc)
    records = []
    for it in range(ITERS):
        rng = np.random.RandomState(100 + it)
        h = AE.max_dim
        b = {"img": (rng.randn(6, h, h, 3) * 0.3).astype(np.float32),
             "flow_img": rng.randn(2, h, h, 2).astype(np.float32),
             "mask_img": (rng.rand(2, h, h, 1) > 0.5).astype(np.float32)}
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        key = jax.random.fold_in(jax.random.PRNGKey(1), it)
        generator = torch.Generator().manual_seed(it)
        for kind in ("g", "d", "r1"):
            if kind == "r1" and it % AE.d_reg_every:
                continue
            before = (jstate.gen, jstate.disc, float(jstate.ada_p))
            if kind == "g":
                jstate, jm, jfake = jfn["g"](jstate, jb, key)
            elif kind == "d":
                jstate, jm = jfn["d"](jstate, jb, jfake, key)
            else:
                jstate, jm = jfn["r1"](jstate, jb, key)
            rec = {"it": it, "kind": kind, "jm": {k: float(v) for k, v in jm.items()},
                   "jada": (float(jstate.ada_p), float(jstate.ada_rt))}
            jopt = jstate.opt_g if kind == "g" else jstate.opt_d
            for name, run in runs.items():
                state, step = run["state"], run["steps"][kind]
                if name == "synced":
                    load_params(state.gen, flatten_params(before[0], dtype=None))
                    load_params(state.disc, flatten_params(before[1], dtype=None))
                    state.ada_p = torch.tensor(before[2])
                run["aug"].load(key, kind, 4)  # the 4 images that are no corrupted contexts
                if kind == "g":
                    state, m, run["fake"] = step(state, tb, "img", generator)
                elif kind == "d":
                    state, m = step(state, tb, run["fake"], "img", generator)
                else:
                    state, m = step(state, tb, "img", generator)
                assert not run["aug"].queue, "a drawn augmentation was not used"
                mod = state.gen if kind == "g" else state.disc
                run["state"] = state
                rec[name] = {"m": {k: float(v) for k, v in m.items()}, "grad": _grads(mod),
                             "ada": (float(state.ada_p), float(state.ada_rt))}
                rec["jgrad"] = port_tree(mod, jopt[0].mu)
            records.append(rec)
    return records


@pytest.mark.parametrize("i", range(8), ids=lambda i: ["g0", "d0", "r1_0", "g1", "d1", "g2", "d2",
                                                       "r1_2"][i])
def test_ada_steps_match_ccvs_tpu(ada_runs, i):
    """Each image step with ADA at the JAX package's parameters and
    ``ada_p``: the loss terms within rtol 1e-5, the gradient of every
    parameter the step updates within rtol 1e-4 plus 1e-4 of the step's
    largest entry (R1's through the augmentation, a second derivative);
    after the D step the controller's ``ada_p`` and ``ada_rt`` (and the
    metric ``rt_stat``) equal to the JAX package's."""
    rec = ada_runs[i]
    got = rec["synced"]
    assert set(got["m"]) == set(rec["jm"]), set(got["m"]) ^ set(rec["jm"])
    for k, v in rec["jm"].items():
        assert got["m"][k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
    scale = largest(rec["jgrad"].values())
    assert scale > 0
    for n, want in rec["jgrad"].items():
        close(got["grad"][n], want, rtol=1e-4, rel_atol=1e-4, scale=scale, what=n)
    assert got["ada"] == pytest.approx(rec["jada"], abs=1e-7)
    if rec["kind"] == "d":
        assert got["m"]["rt_stat"] == rec["jada"][1]


def test_free_running_ada_matches_ccvs_tpu(ada_runs):
    """The port on its own: the probability after every step as the JAX
    package's, 0, 0.4, 0.8, then clipped at 1 (raised by ``n /
    ada_length`` each D step), and the loss terms within rtol 1e-4."""
    for rec in ada_runs:
        assert rec["free"]["ada"][0] == pytest.approx(rec["jada"][0], abs=1e-7)
        for k, v in rec["jm"].items():
            assert rec["free"]["m"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), (rec["it"], k)
    p = [rec["jada"][0] for rec in ada_runs if rec["kind"] == "d"]
    assert p == pytest.approx([0.4, 0.8, 1.0])


def _tiny_config(tmp_path, **ae):
    from test_torch_ae_trainer import _ae_config

    return _ae_config(tmp_path, use_aug=True, aug_p=0.0, ada_target=-1.5, ada_length=40, **ae)


def test_resumed_run_continues_ada_p(tmp_path):
    """``FrameAutoencoderTrainer.run`` with ADA: ``ada_p`` goes into the
    checkpoint and is logged at each eval; a run resumed at iteration 2
    enters it with the ``ada_p`` that the uninterrupted run has there (not
    ``aug_p``), and leaves it with the same (4 real images, ``ada_length``
    40: 0.1 a D step). The iterations' augmentation draws come from the
    ``(seed, it)`` generators (``test_torch_ae_trainer.py``)."""
    from test_torch_ae_trainer import _metrics

    seen = {}

    def run(name, n_iter, resume=False, eval_every=0):
        tr = FrameAutoencoderTrainer(_tiny_config(tmp_path).replace(name=name),
                                     dtype=torch.float32, device="cpu")
        iteration = tr.iteration

        def recording(state, it, *args):
            p = float(state.ada_p)
            out = iteration(state, it, *args)
            seen[name, it] = p, float(out[0].ada_p)
            return out

        tr.iteration = recording
        return tr.run(n_iter=n_iter, resume=resume, eval_every=eval_every)

    whole = run("whole", 3, eval_every=1)
    run("cut", 2)
    resumed = run("cut", 3, resume=True)
    assert [p for it in range(3) for p in seen["whole", it]] == pytest.approx(
        [0, 0.1, 0.1, 0.2, 0.2, 0.3])
    assert seen["cut", 2] == seen["whole", 2]
    assert float(resumed.ada_p) == float(whole.ada_p)
    logged = [d["qvid_eval/ada_p"] for d in _metrics(tmp_path, "whole") if "qvid_eval/ada_p" in d]
    assert logged == pytest.approx([0.1, 0.2, 0.3])


R5_CONFIGS = sorted(glob.glob(os.path.join(REPO, "runs_r5", "r5_*_eval_config.json")))


@pytest.mark.parametrize("path", R5_CONFIGS, ids=os.path.basename)
def test_trained_configuration_takes_an_iteration(path):
    """Each trained configuration of ``runs_r5/`` (64 px, ADA with the
    adaptive probability, the video discriminator, VGG19 on images) loads
    and builds a ``FrameAutoencoderTrainer``, which takes iteration 0 (G,
    D and R1 for images and for video, the R1 through the augmentation) on
    the CPU. Cut: a batch of 2 images and 1 clip of 4 frames (the config's
    24 and 4). Every loss term finite, ``ada_p`` moved off 0 by
    ``2 / ada_length`` or kept at 0."""
    cfg = Config.load(path)
    assert cfg.ae.use_aug and cfg.ae.aug_p == 0.0
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size_img=2, batch_size_vid=1))
    tr = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu")
    tr.init_params()
    state = tr.init_state()
    from ccvs_tpu_torch.data import create_dataset, group_collate

    img_ds = create_dataset(cfg.data, phase="train", load_vid=False)
    vid_ds = create_dataset(dataclasses.replace(cfg.data, vid_len=cfg.ae.vid_len),
                            phase="train", load_vid=True)
    img = to_device(group_collate([img_ds[0]]), "cpu")
    vid = to_device(group_collate([vid_ds[0]]), "cpu")
    assert img["img"].shape == (2, 64, 64, 3) and vid["vid"].shape == (1, 4, 64, 64, 3)
    state, gm, dm, _ = tr.iteration(state, 0, img, vid, iteration_generator(cfg.seed, 0))
    assert {"r1_img", "r1_vid", "gen_img", "dis_img", "rt_stat"} <= set(gm) | set(dm)
    bad = [k for k, v in {**gm, **dm}.items() if not math.isfinite(float(v))]
    assert not bad, bad
    assert float(state.ada_p) in (0.0, pytest.approx(2 / cfg.ae.ada_length))
