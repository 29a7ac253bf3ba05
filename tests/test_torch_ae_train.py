"""The frame autoencoder's adversarial training in ccvs_tpu_torch against
ccvs_tpu, on the CPU in fp32: the discriminators, ``conv3d``, the VGG loss,
the GAN losses and R1's double backward, the index plans, the Adam
schedules, and three iterations of ``make_ae_steps`` (the image G, D and R1
steps and the video G, D and R1 steps), which hold every step's metrics and
gradient (image and video generator losses, both discriminator losses, both
R1 losses), the parameters, the EMA and both Adam states.

The steps' configuration is ``tests/test_train.py``'s ``AE_CFG`` (8 px, VGG
off) with every other ported branch on: the feature discriminator, the
unconditional head, backwarp consistency, elastic mask and flow recovery
and an lr step decay. The perceptual term is held at 16 px on its own
(``test_torch_ae_trainer.py``): at 8 px VGG19's fourth pooling leaves no
pixel and the loss is NaN in both packages.

The JAX side runs the six steps under ``jax.jit`` (``fast_jit``: XLA's
quick compile options), built once for the module. With Adam's ``beta1 = 0`` the first moment after a step is that
step's gradient, so ``opt.mu`` gives the JAX gradient of every step. Each
test states its tolerance."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.nn import discriminators as jdisc
from ccvs_tpu.nn import vgg as jvgg
from ccvs_tpu.nn import layers as jl
from ccvs_tpu.ops import convops as jconv
from ccvs_tpu.port.npz_params import flatten_params
from ccvs_tpu.train import gan_losses as jgl
from ccvs_tpu.train import states as jstates
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu.train.ae_losses import AELosses as JLosses
from ccvs_tpu_torch.models import FrameAutoencoder
from ccvs_tpu_torch.nn import discriminators as tdisc
from ccvs_tpu_torch.nn import layers as tl
from ccvs_tpu_torch.nn import vgg as tvgg
from ccvs_tpu_torch.ops.convops import conv3d
from ccvs_tpu_torch.train import gan_losses as tgl
from ccvs_tpu_torch.train import states as tstates
from ccvs_tpu_torch.train.ae_losses import AELosses
from ccvs_tpu_torch.train.steps import make_ae_steps
from ccvs_tpu_torch.weights import load_params
from test_train import AE_CFG
from test_torch_train import close, largest
from torch_parity import (fast_jit, few_threads, jax_params, load_into, port_config, set_fp32,
                          to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")

AE = dataclasses.replace(AE_CFG, use_df=True, use_unc_gen=True,
                         use_backwarp_consistency_img=True, lr_decay_at=(5,), lr_decay_mult=0.5)
H = AE.max_dim
B_VID = 4  # the feature discriminator groups the B * T video latents by 4
ITERS = 3


def vgg_tree(seed, arch="vgg19"):
    rng = np.random.RandomState(seed)
    out = {}
    for i, (kind, cin, cout) in enumerate(jvgg._layer_plan(arch)):
        if kind == "conv":
            out[f"conv{i}"] = {
                "weight": jnp.asarray((rng.randn(cout, cin, 3, 3) * np.sqrt(2 / (cin * 9)))
                                      .astype(np.float32)),
                "bias": jnp.asarray((rng.randn(cout) * 0.1).astype(np.float32))}
    return out


def port_tree(module, tree):
    """A JAX param tree as ``module``'s parameter names -> tensors."""
    holder = load_params(copy.deepcopy(module), flatten_params(tree, dtype=None))
    return {n: p.detach().clone() for n, p in holder.named_parameters()}


def batches(it, h=H):
    rng = np.random.RandomState(100 + it)
    img = {"img": (rng.randn(6, h, h, 3) * 0.3).astype(np.float32),
           "flow_img": rng.randn(2, h, h, 2).astype(np.float32),
           "mask_img": (rng.rand(2, h, h, 1) > 0.5).astype(np.float32)}
    vid = {"vid": (rng.randn(B_VID, AE.vid_len, h, h, 3) * 0.3).astype(np.float32)}
    return img, vid


def port_models(cfg, gen, disc, vgg=None):
    pcfg = port_config(cfg)
    ae = load_into(FrameAutoencoder(pcfg, dtype=torch.float32, device="cpu"), gen)
    ds = torch.nn.ModuleDict({"di": tdisc.ImageDiscriminator(pcfg),
                              "dv": tdisc.VideoDiscriminator(pcfg, pcfg.vid_len),
                              "df": tdisc.FeatureDiscriminator(pcfg)})
    load_into(ds, disc)
    v = load_into(tvgg.VGG(), vgg) if vgg is not None else None
    return AELosses(pcfg, ae, ds["di"], ds["dv"], ds["df"], v)


def jax_models(cfg):
    h = cfg.max_dim
    ae = JAE(cfg, dtype=F32)
    di, dv = jdisc.ImageDiscriminator(cfg), jdisc.VideoDiscriminator(cfg, vid_len=cfg.vid_len)
    df = jdisc.FeatureDiscriminator(cfg)
    losses = JLosses(cfg, ae, di=di, dv=dv, df=df)
    gen = jax_params(ae.init, seed=1)
    disc = jax_params(lambda k: {
        "di": di.init(k, jnp.zeros((2, h, h, 3)))["params"],
        "dv": dv.init(k, jnp.zeros((2, cfg.vid_len, h, h, 3)))["params"],
        "df": df.init(k, jnp.zeros((4, *cfg.z_shape, cfg.z_size)))["params"]}, seed=2)
    return losses, gen, disc


SEQUENCE = [("g", "img"), ("d", "img"), ("r1", "img"), ("g", "vid"), ("d", "vid"), ("r1", "vid")]


def _steps_of(it):
    return [(k, m) for k, m in SEQUENCE if k != "r1" or it % AE.d_reg_every == 0]


def _run_port(steps, state, kind, mode, batch, fake):
    tg, td, tr = steps
    if kind == "g":
        state, m, fake = tg(state, batch, mode)
        return state, m, fake, state.gen, state.opt_g
    if kind == "d":
        state, m = td(state, batch, fake, mode)
    else:
        state, m = tr(state, batch, mode)
    return state, m, fake, state.disc, state.opt_d


def _params(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _grads(module):
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    """The same three iterations through both packages. The port runs them
    twice: on its own ("free"), and "synced", taking the JAX parameters
    before every step, so that each step's metrics and gradients are those
    of identical parameters. Recorded after every step: the metrics, the
    gradient, the parameters, the EMA and the second moments."""
    jlosses, gen, disc = jax_models(AE)
    jinit, jg, jd, jr = jsteps.make_ae_steps(jlosses, None)
    jfn = {("g", m): fast_jit(lambda s, b, r, m=m: jg(s, b, r, m)) for m in ("img", "vid")}
    jfn.update({("d", m): fast_jit(lambda s, b, f, r, m=m: jd(s, b, f, r, m))
                for m in ("img", "vid")})
    jfn.update({("r1", m): fast_jit(lambda s, b, m=m: jr(s, b, m)) for m in ("img", "vid")})
    free, synced = port_models(AE, gen, disc), port_models(AE, gen, disc)
    finit, *fsteps = make_ae_steps(free)
    sinit, *ssteps = make_ae_steps(synced)
    jstate, fstate, sstate = jinit(jax.random.PRNGKey(0), gen, disc), finit(), sinit()
    start = {"gen": _params(fstate.gen), "disc": _params(fstate.disc)}
    key = jax.random.PRNGKey(1)
    records = []
    for it in range(ITERS):
        bi, bv = batches(it)
        b = {"img": bi, "vid": bv}
        jfake, ffake, sfake = {}, {}, {}
        for kind, mode in _steps_of(it):
            jb = {k: jnp.asarray(v) for k, v in b[mode].items()}
            tb = {k: torch.from_numpy(v) for k, v in b[mode].items()}
            load_params(sstate.gen, flatten_params(jstate.gen, dtype=None))
            load_params(sstate.disc, flatten_params(jstate.disc, dtype=None))
            if kind == "g":
                jstate, jm, jfake[mode] = jfn[kind, mode](jstate, jb, key)
                jopt = jstate.opt_g
            elif kind == "d":
                jstate, jm = jfn[kind, mode](jstate, jb, jfake[mode], key)
                jopt = jstate.opt_d
            else:
                jstate, jm = jfn[kind, mode](jstate, jb)
                jopt = jstate.opt_d
            fstate, fm, ffake[mode], fmod, fopt = _run_port(fsteps, fstate, kind, mode, tb,
                                                            ffake.get(mode))
            sstate, sm, sfake[mode], smod, _ = _run_port(ssteps, sstate, kind, mode, tb,
                                                         sfake.get(mode))
            records.append({
                "it": it, "kind": kind, "mode": mode, "part": "gen" if kind == "g" else "disc",
                "jm": {k: float(v) for k, v in jm.items()},
                "fm": {k: float(v) for k, v in fm.items()},
                "sm": {k: float(v) for k, v in sm.items()},
                "fgrad": _grads(fmod), "sgrad": _grads(smod),
                "jgrad": port_tree(fmod, jopt[0].mu),
                "params": _params(fmod),
                "jparams": port_tree(fmod, jstate.gen if kind == "g" else jstate.disc),
                "nu": {n: fopt.opt.state[p]["exp_avg_sq"].clone()
                       for n, p in fmod.named_parameters()},
                "jnu": port_tree(fmod, jopt[0].nu),
                "count": fopt.count, "jcount": int(jopt[0].count),
                "lr": fopt.opt.param_groups[0]["lr"],
                "beta2": fopt.opt.param_groups[0]["betas"][1],
                "ema": _params(fstate.ema) if kind == "g" else None,
                "jema": port_tree(fstate.ema, jstate.ema) if kind == "g" else None,
            })
    return {"records": records, "start": start}


def _record(runs, it, kind, mode):
    return next(r for r in runs["records"] if (r["it"], r["kind"], r["mode"]) == (it, kind, mode))


@pytest.mark.parametrize("it,kind,mode", [(it, k, m) for it in range(ITERS)
                                           for k, m in _steps_of(it)])
def test_step_metrics_and_gradients_match_ccvs_tpu(runs, it, kind, mode):
    """Every step of the three iterations (R1 every ``d_reg_every = 2``) at
    the JAX package's parameters: the loss terms (the image and video
    generator losses, the discriminator losses, R1) within rtol 1e-5 and
    the gradient of every parameter the step updates within rtol 1e-4 plus
    1e-4 of the step's largest entry (R1's is a second derivative: rounding
    in the input gradient reaches every weight's)."""
    rec = _record(runs, it, kind, mode)
    assert set(rec["sm"]) == set(rec["jm"]), set(rec["sm"]) ^ set(rec["jm"])
    for k, v in rec["jm"].items():
        assert rec["sm"][k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
    scale = largest(rec["jgrad"].values())
    assert scale > 0
    for n, want in rec["jgrad"].items():
        close(rec["sgrad"][n], want, rtol=1e-4, rel_atol=1e-4, scale=scale, what=n)


def test_every_ported_loss_term_is_exercised(runs):
    keys = set().union(*(r["jm"] for r in runs["records"]))
    assert keys == {
        "quant_img", "mask_rec_img", "elastic_flow_rec_img", "backwarp_consistency_img",
        "rec_img", "gen_img", "gen_feat_fake", "dis_img", "dis_feat_fake", "r1_img",
        "quant_vid", "rec_vid", "gen_vid", "gen_img_unc", "per_img_unc", "gen_feat_real",
        "dis_vid", "dis_img_unc", "dis_feat_real", "r1_vid", "g_loss", "d_loss"}


class AdamB0Bound:
    """Bounds on ``|got - want|`` for the parameters (and their EMA) of two
    runs of Adam with ``beta1 = 0`` from the same start, built step by step
    from the reference run (``want``, the JAX package's): its parameters
    after each step and its gradient. Such an update is ``lr g /
    sqrt(v_hat)``, of the order of ``lr`` whatever the gradient's size, and
    at most ``lr sqrt((1 - beta2^t) / (1 - beta2))``. Where the step's
    gradient is within 1e-3 of its largest entry, rounding decides the
    update's sign, and the step adds that largest update plus the
    reference's own; elsewhere it adds 1e-3 of the reference's update (the
    gradients agree within 1e-4, :func:`test_step_metrics_and_gradients_match_ccvs_tpu`).
    Each step adds two fp32 spacings of the parameter, and the EMA's bound
    follows the EMA's recursion."""

    def __init__(self, start):
        self.prev = {n: p.double() for n, p in start.items()}
        self.bound = {n: torch.zeros_like(p, dtype=torch.float64) for n, p in start.items()}
        self.ema = {n: b.clone() for n, b in self.bound.items()}

    def step(self, params, grads, lr, beta2, t, ema_decay=None):
        eps = torch.finfo(torch.float32).eps
        scale = largest(grads.values())
        top = lr * ((1 - beta2**t) / (1 - beta2)) ** 0.5
        for n, p in params.items():
            p = p.double()
            u = (p - self.prev[n]).abs()
            tight = grads[n].abs() > 1e-3 * scale
            self.bound[n] += torch.where(tight, 1e-3 * u, top + u) + 2 * eps * p.abs()
            if ema_decay is not None:
                self.ema[n] = (ema_decay * self.ema[n] + (1 - ema_decay) * self.bound[n]
                               + 2 * eps * p.abs())
            self.prev[n] = p


def _assert_within(got, want, bound, what):
    for n, w in want.items():
        excess = float(((got[n].double() - w.double()).abs() - bound[n]).max())
        assert excess <= 0, f"{what} {n}: beyond the Adam bound by {excess:.3g}"


def test_three_iterations_match_ccvs_tpu(runs):
    """The port on its own for three iterations: after every step the
    metrics within rtol 1e-4, the update counts equal, the parameters and
    the EMA within :class:`AdamB0Bound`, the second moments within rtol
    1e-3 plus 1e-3 of their largest entry (squares of gradients taken at
    parameters that differ by that bound)."""
    bounds = {part: AdamB0Bound(start) for part, start in runs["start"].items()}
    for rec in runs["records"]:
        what = (rec["it"], rec["kind"], rec["mode"])
        for k, v in rec["jm"].items():
            assert rec["fm"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), (what, k)
        assert rec["count"] == rec["jcount"]
        bd = bounds[rec["part"]]
        bd.step(rec["jparams"], rec["jgrad"], rec["lr"], rec["beta2"], rec["count"],
                AE.ema_decay if rec["ema"] is not None else None)
        _assert_within(rec["params"], rec["jparams"], bd.bound, what)
        if rec["ema"] is not None:
            _assert_within(rec["ema"], rec["jema"], bd.ema, what)
        nscale = largest(rec["jnu"].values())
        for n, v in rec["nu"].items():
            close(v, rec["jnu"][n], rtol=1e-3, rel_atol=1e-3, scale=nscale, what=n)


def test_lr_schedule_follows_the_update_count(runs):
    """``lr_decay_at=(5,)``: each optimizer's sixth update on runs at half
    the lr (the generator's: the third iteration's image step); the
    discriminators' lr is ``lr * d_reg_every / (d_reg_every + 1)``."""
    g = [r["lr"] for r in runs["records"] if r["kind"] == "g"]
    assert g == pytest.approx([AE.lr] * 5 + [AE.lr * 0.5])
    d_ratio = AE.d_reg_every / (AE.d_reg_every + 1)
    d = [r["lr"] for r in runs["records"] if r["part"] == "disc"]
    assert d == pytest.approx([AE.lr * d_ratio] * 5 + [AE.lr * d_ratio * 0.5] * (len(d) - 5))


# ---------------- the pieces ----------------


@pytest.mark.parametrize("lr_decay_at", [0, 3, (2, 5)])
def test_ae_optimizer_schedules_match_optax(lr_decay_at):
    cfg = dataclasses.replace(AE, lr_decay_at=lr_decay_at, lr_decay_mult=0.3, g_reg_every=4)
    jopt_g, jopt_d = jstates.make_ae_optimizers(cfg)
    p = [torch.nn.Parameter(torch.zeros(1))]
    topt_g, topt_d = tstates.make_ae_optimizers(port_config(cfg), p, p)
    for topt, ratio in ((topt_g, 4 / 5), (topt_d, 2 / 3)):
        b1, b2 = topt.opt.param_groups[0]["betas"]
        assert (b1, b2) == pytest.approx((cfg.beta1**ratio, cfg.beta2**ratio))
    pts = lr_decay_at if isinstance(lr_decay_at, tuple) else (lr_decay_at,) if lr_decay_at else ()
    want = optax.piecewise_constant_schedule(cfg.lr, {q: 0.3 for q in pts}) if pts else None
    for count in range(8):
        got = topt_g.schedules[0](count)
        expect = float(want(count)) * 4 / 5 if want else cfg.lr * 4 / 5
        assert got == pytest.approx(expect, rel=1e-6)
    del jopt_g, jopt_d


@pytest.mark.parametrize("n,elastic,slide,corr", [(2, True, True, True), (2, True, False, True),
                                                  (1, False, False, False), (3, False, True, False),
                                                  (3, True, True, False)])
def test_index_plans_match_ccvs_tpu(n, elastic, slide, corr):
    cfg = dataclasses.replace(AE_CFG, n_consecutive_img=n, load_elastic_view=elastic,
                              slide_inter=slide, elastic_corruption=corr)
    j = JLosses(cfg, None)
    t = AELosses(port_config(cfg), None)
    b = 4 * j.group_size()
    assert t.group_size() == j.group_size()
    np.testing.assert_array_equal(t.slide_indices(b), j.slide_indices(b))
    for a, w in zip(t.corr_split(b), j.corr_split(b)):
        np.testing.assert_array_equal(a, w)
    np.testing.assert_array_equal(t.elastic_indices(8), j.elastic_indices(8))


@pytest.mark.parametrize("which", ["image", "video", "feature", "image_consecutive"])
def test_discriminators_and_gradients_match_ccvs_tpu(which):
    cfg = AE
    rng = np.random.RandomState(5)
    if which == "image_consecutive":
        cfg = dataclasses.replace(AE, n_consecutive_dis=2, downsample_dis_num=1)
    pcfg = port_config(cfg)
    if which in ("image", "image_consecutive"):
        jm, tm = jdisc.ImageDiscriminator(cfg), tdisc.ImageDiscriminator(pcfg)
        x = rng.randn(8 if which == "image_consecutive" else 4, H, H, 3).astype(np.float32)
    elif which == "video":
        jm, tm = jdisc.VideoDiscriminator(cfg, vid_len=4), tdisc.VideoDiscriminator(pcfg, 4)
        x = rng.randn(4, 4, H, H, 3).astype(np.float32)
    else:
        jm, tm = jdisc.FeatureDiscriminator(cfg), tdisc.FeatureDiscriminator(pcfg)
        x = rng.randn(2, 2, *cfg.z_shape, cfg.z_size).astype(np.float32)
    params = jax_params(lambda k: jm.init(k, jnp.asarray(x))["params"], seed=6)
    w = rng.randn(x.shape[0] // cfg.n_consecutive_dis if which != "feature" else 4, 1)

    def f(p, x):
        out = jm.apply({"params": p}, x)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = fast_jit(jax.value_and_grad(f, (0, 1), has_aux=True))(params, x)
    load_into(tm, params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tm(tx)
    (out * torch.from_numpy(w).float()).sum().backward()
    close(out, jout, rtol=1e-5, rel_atol=1e-6)
    close(tx.grad, jgx, rtol=1e-5, rel_atol=1e-6)
    want = port_tree(tm, jgp)
    scale = largest(want.values())
    for n, p in tm.named_parameters():
        close(p.grad, want[n], rtol=1e-5, rel_atol=1e-6, scale=scale, what=n)


@pytest.mark.parametrize("stride,padding,groups", [((1, 1, 1), (1, 1, 1), 1),
                                                   ((1, 2, 2), (0, 0, 0), 1),
                                                   ((2, 1, 2), (1, 0, 1), 2)])
def test_conv3d_matches_ccvs_tpu(stride, padding, groups):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 9, 8, 4).astype(np.float32)
    w = rng.randn(6, 4 // groups, 3, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = jconv.conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                        padding=padding, groups=groups)
    got = conv3d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride,
                 padding=padding, groups=groups)
    close(got, want, rtol=1e-5, rel_atol=1e-6)


def test_minibatch_stddev_groups_interleaved():
    """Item ``i`` is grouped with the items ``B / group`` apart, as
    ``reshape(group, -1, ...)`` groups them (not consecutive items)."""
    rng = np.random.RandomState(8)
    x = rng.randn(6, 3, 3, 4).astype(np.float32)
    v = rng.randn(4, 2, 3, 3, 4).astype(np.float32)
    close(tl.minibatch_stddev(torch.from_numpy(x), 2), jl.minibatch_stddev(jnp.asarray(x), 2),
          rtol=1e-6)
    close(tl.minibatch_stddev_3d(torch.from_numpy(v), 4),
          jl.minibatch_stddev_3d(jnp.asarray(v), 4), rtol=1e-6)
    got = to_np(tl.minibatch_stddev(torch.from_numpy(x), 2))[:, 0, 0, -1]
    assert got[0] == pytest.approx(got[3]) and got[0] != pytest.approx(got[1])


@pytest.mark.parametrize("arch", ["vgg19", "vgg16"])
def test_vgg_loss_matches_ccvs_tpu(arch):
    """The loss of both backbones; its gradient is held through the image
    generator loss (``test_torch_ae_trainer.py``)."""
    rng = np.random.RandomState(9)
    fake = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tree = vgg_tree(10, arch)
    want = fast_jit(jvgg.vgg_loss)(tree, fake, real)
    v = load_into(tvgg.VGG(arch), tree)
    tf = torch.from_numpy(fake).requires_grad_(True)
    loss = tvgg.vgg_loss(v, tf, torch.from_numpy(real))
    loss.backward()
    close(loss, want, rtol=1e-5)
    assert tf.grad is not None and all(p.grad is None for p in v.parameters())


def test_vgg_npz_and_seeded_fallback(tmp_path):
    tree = vgg_tree(11)
    raw = {f"features.{k[len('conv'):]}.{leaf}": np.asarray(a)
           for k, d in tree.items() for leaf, a in d.items()}
    np.savez(tmp_path / "vgg19.npz", **raw)
    v = tvgg.make_vgg(str(tmp_path / "vgg19.npz"))
    assert v.arch == "vgg19" and set(dict(v.named_parameters())) == {
        f"{k}.{leaf}" for k, d in tree.items() for leaf in d}
    close(v.conv28.weight, tree["conv28"]["weight"], rtol=0)
    a, b = tvgg.make_vgg(seed=3, device="cpu"), tvgg.make_vgg(seed=3, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    std = float(a.conv2.weight.std())
    assert std == pytest.approx(np.sqrt(2 / (64 * 9)), rel=0.05)
    with pytest.raises(FileNotFoundError):
        tvgg.make_vgg(str(tmp_path / "missing.npz"))


def test_gan_losses_match_ccvs_tpu():
    rng = np.random.RandomState(12)
    r, f = rng.randn(6, 1).astype(np.float32), rng.randn(6, 1).astype(np.float32)
    tr, tf = torch.from_numpy(r), torch.from_numpy(f)
    for name in ("g_logistic", "d_logistic_fake_only", "d_logistic_real_only",
                 "g_logistic_real", "g_hinge", "g_original", "g_wgan"):
        close(getattr(tgl, name)(tf), getattr(jgl, name)(jnp.asarray(f)), rtol=1e-6, what=name)
    for name in ("d_logistic", "d_hinge", "d_original"):
        close(getattr(tgl, name)(tr, tf), getattr(jgl, name)(jnp.asarray(r), jnp.asarray(f)),
              rtol=1e-6, what=name)
    close(tgl.d_wgan(tr, tf, torch.tensor(0.3)), jgl.d_wgan(r, f, 0.3), rtol=1e-6)
    assert set(tgl.GENERATOR_LOSSES) == set(jgl.GENERATOR_LOSSES)
    assert set(tgl.DISCRIMINATOR_LOSSES) == set(jgl.DISCRIMINATOR_LOSSES)


def _toy_d(w):
    """A small nonlinear "discriminator" of (B, 4, 4, 3) inputs and its
    weights (4*4*3, 5) and (5,)."""
    def jd(p, x):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["w"])
        return (h * h) @ p["v"]

    def td(p, x):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ p["w"])
        return (h * h) @ p["v"]

    return jd, td


def test_r1_penalty_double_backward_matches_jax_grad_of_grad():
    """The penalty's gradient with respect to the discriminator's weights
    goes through the input gradient (``create_graph=True``): against
    ``jax.grad`` of a function that calls ``jax.grad``."""
    rng = np.random.RandomState(13)
    x = rng.randn(3, 4, 4, 3).astype(np.float32)
    p = {"w": rng.randn(48, 5).astype(np.float32) * 0.3, "v": rng.randn(5).astype(np.float32)}
    jd, td = _toy_d(p)
    jval, jgrad = jax.value_and_grad(
        lambda q: jgl.r1_penalty(lambda y: jd(q, y), jnp.asarray(x)))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    val = tgl.r1_penalty(lambda y: td(tp, y), torch.from_numpy(x))
    val.backward()
    close(val, jval, rtol=1e-5)
    for k in p:
        close(tp[k].grad, jgrad[k], rtol=1e-4, rel_atol=1e-6, what=k)


class _Convolutions(TorchDispatchMode):
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.convolution.default:
            _Convolutions.n += 1
        return func(*args, **(kwargs or {}))


def _upfirdn2d_autograd(x, kernel, up, down, pad):
    """``upfirdn2d`` as one grouped ``F.conv2d`` left to PyTorch's autograd."""
    b, h, w, c = x.shape
    t = x.permute(0, 3, 1, 2)
    if up > 1:
        stuffed = t.new_zeros(b, c, h * up, w * up)
        stuffed[:, :, ::up, ::up] = t
        t = stuffed
    t = torch.nn.functional.pad(t, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.flip(kernel, (0, 1))[None, None].expand(c, 1, *kernel.shape)
    return torch.nn.functional.conv2d(t, k, stride=down, groups=c).permute(0, 2, 3, 1)


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1)), (1, 2, (1, 1)), (2, 1, (2, 1))])
def test_upfirdn2d_double_backward_is_autograd_s_in_few_convolutions(up, down, pad):
    """R1 differentiates the blur twice. ``upfirdn2d`` differentiates its
    depthwise convolution by hand: an R1-like penalty's input gradient and
    its gradient are those of PyTorch's own autograd of the grouped
    convolution (float64, within 1e-12 relative), in 5 convolutions where
    PyTorch's own double backward adds one a channel."""
    from ccvs_tpu_torch.ops.upfirdn2d import make_resample_kernel, upfirdn2d

    rng = np.random.RandomState(17)
    c = 6
    x0 = torch.from_numpy(rng.randn(2, 9, 9, c))
    w = torch.from_numpy(rng.randn(4, c, 3, 3))
    k = make_resample_kernel([1, 3, 3, 1]).double()
    got = {}
    for name, f in (("port", upfirdn2d), ("autograd", _upfirdn2d_autograd)):
        x = x0.clone().requires_grad_(True)
        _Convolutions.n = 0
        with _Convolutions():
            y = torch.nn.functional.conv2d(f(x, k, up, down, pad).permute(0, 3, 1, 2), w)
            g, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
            (g.square().sum() + g.sum()).backward()
        got[name] = (g.detach(), x.grad, _Convolutions.n)
    for a, b in zip(got["port"][:2], got["autograd"][:2]):
        close(a, b, rtol=1e-12, rel_atol=1e-12)
    assert (got["port"][2], got["autograd"][2]) == (5, 5 + c)


def test_wgan_gradient_penalty_matches_ccvs_tpu():
    """Same interpolation weights in both: the port's draw from its
    generator, handed to JAX through a mixing that reproduces them."""
    rng = np.random.RandomState(14)
    xr, xf = rng.randn(3, 4, 4, 3).astype(np.float32), rng.randn(3, 4, 4, 3).astype(np.float32)
    p = {"w": rng.randn(48, 5).astype(np.float32) * 0.3, "v": rng.randn(5).astype(np.float32)}
    jd, td = _toy_d(p)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    got = tgl.wgan_gradient_penalty(lambda y: td(tp, y), torch.from_numpy(xr),
                                    torch.from_numpy(xf), torch.Generator().manual_seed(0))
    got.backward()
    alpha = to_np(torch.rand((3, 1, 1, 1), generator=torch.Generator().manual_seed(0)))
    interp = alpha * xr + (1 - alpha) * xf

    def jgp(q):
        g = jax.grad(lambda y: jnp.sum(jd(q, y)))(jnp.asarray(interp)).reshape(3, -1)
        return jnp.mean((jnp.linalg.norm(g, axis=1) - 1.0) ** 2)

    jval, jgrad = jax.value_and_grad(jgp)({k: jnp.asarray(v) for k, v in p.items()})
    close(got, jval, rtol=1e-5)
    for k in p:
        close(tp[k].grad, jgrad[k], rtol=1e-4, rel_atol=1e-6, what=k)


def test_decoder_keep_mask_and_no_context_match_ccvs_tpu():
    """``keep_mask`` (the ``inter_drop_p`` draw: items with 0 skip the
    fusion), ``inter_pre_warping=False`` and ``has_ctx=False``, with two
    contexts and no ``ctx_mask``, as the video rollout passes them."""
    jae = JAE(AE, dtype=F32)
    gen = jax_params(jae.init, seed=15)
    ae = load_into(FrameAutoencoder(port_config(AE), dtype=torch.float32, device="cpu"), gen)
    rng = np.random.RandomState(16)
    z = rng.randn(3, *AE.z_shape, AE.z_size).astype(np.float32)
    ctxs = [[rng.randn(3, *s[1:]).astype(np.float32) for s in jae.inter_shapes(3)]
            for _ in range(2)]
    km = np.array([1.0, 0.0, 1.0], np.float32)

    def jdec(p, z, ctxs, km):
        a = jae.decoder.apply({"params": p}, z, ctxs, return_all=True, keep_mask=km,
                              inter_pre_warping=False)
        b = jae.decoder.apply({"params": p}, z, None, has_ctx=False)
        return a, b

    (jrgb, _, jflows, jocc, jdec_), (jnoctx, _) = fast_jit(jdec)(gen["decoder"], z, ctxs, km)
    tctx = [[torch.from_numpy(f) for f in c] for c in ctxs]
    rgb, layout, flows, occs, inter_dec = ae.decoder(
        torch.from_numpy(z), ae.decoder.stack_contexts(tctx), return_all=True,
        keep_mask=torch.from_numpy(km), inter_pre_warping=False)
    assert layout is None
    close(rgb, jrgb, rtol=1e-4, rel_atol=1e-5)
    for got, want in zip(flows + occs + inter_dec, list(jflows) + list(jocc) + list(jdec_)):
        close(got, want, rtol=1e-4, rel_atol=1e-5)
    close(ae.decoder(torch.from_numpy(z), None), jnoctx, rtol=1e-4, rel_atol=1e-5)
