"""The parallel layer of ccvs_tpu_torch (``parallel/``, the trainers'
``mesh=``) against ccvs_tpu's, on the CPU over gloo.

A module fixture spawns the ranks once (``tests/torch_ranks.py``: two, then
four processes, one intra-op thread each, every join under a timeout) and
runs every scenario there, while this process computes the references: the
JAX package's steps on ``make_mesh(2)`` of its 8 virtual CPU devices (GSPMD
computes the global batch's function), and the port's one-process runs
(DP-1). The weights are ccvs_tpu trees filled from a numpy seed and carried
across by ``weights.py``. Each test states its tolerance."""

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks as R
from ccvs_tpu import config as jcfg
from ccvs_tpu.models import FrameAutoencoder as JAE
from ccvs_tpu.models import TokenTransformer as JTT
from ccvs_tpu.nn import discriminators as jdisc
from ccvs_tpu.parallel.mesh import make_mesh as jmake_mesh
from ccvs_tpu.port.npz_params import flatten_params
from ccvs_tpu.train import ada as jada
from ccvs_tpu.train import steps as jsteps
from ccvs_tpu.train.ae_losses import AELosses as JLosses
from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
from ccvs_tpu_torch.nn import discriminators as tdisc
from ccvs_tpu_torch.nn.gpt import GPTCore
from ccvs_tpu_torch.weights import load_params
from torch_parity import (FAST_COMPILE, fast_jit, few_threads, jax_params,  # noqa: F401
                          set_fp32, to_np)

F32 = set_fp32()
pytestmark = pytest.mark.usefixtures("few_threads")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree, dtype=None).items()}


def _batches():
    rng = np.random.RandomState(7)
    img = (rng.randn(R.B_IMG, 8, 8, 3) * 0.5).astype(np.float32)
    vid = (rng.randn(R.B_VID, 3, 8, 8, 3) * 0.5).astype(np.float32)
    codes = [rng.randint(0, 32, (R.B_CODE, 32)).astype(np.int32) for _ in range(2)]
    return img, vid, codes


def _jax_ae(cfg):
    ae = JAE(cfg, dtype=F32)
    di, dv = jdisc.ImageDiscriminator(cfg), jdisc.VideoDiscriminator(cfg, vid_len=cfg.vid_len)
    df = jdisc.FeatureDiscriminator(cfg)
    gen = jax_params(ae.init, seed=1)
    disc = jax_params(lambda k: {"di": di.init(k, jnp.zeros((2, 8, 8, 3)))["params"],
                                 "dv": dv.init(k, jnp.zeros((2, cfg.vid_len, 8, 8, 3)))["params"],
                                 "df": df.init(k, jnp.zeros((2, *cfg.z_shape, cfg.z_size)))[
                                     "params"]},
                      seed=2)
    return JLosses(cfg, ae, di=di, dv=dv, df=df), gen, disc


def _port_ae(gen, disc):
    acfg, _ = R.port_cfgs()
    ae = load_params(FrameAutoencoder(acfg, dtype=torch.float32, device="cpu"), _flat(gen))
    d = torch.nn.ModuleDict({"di": tdisc.ImageDiscriminator(acfg),
                             "dv": tdisc.VideoDiscriminator(acfg, acfg.vid_len),
                             "df": tdisc.FeatureDiscriminator(acfg)})
    return ae, load_params(d, _flat(disc))


def _port_tree(module, tree):
    holder = load_params(copy.deepcopy(module), _flat(tree))
    return {n: p.detach().clone() for n, p in holder.named_parameters()}


def _jax_ae_sequence(jlosses, gen, disc, img, vid, ae_mod, disc_mod):
    """The JAX steps on ``make_mesh(2)``: image G, D and R1, then video G
    and D, with the feature discriminator on: each step's metrics, gradient
    (with beta1 = 0, Adam's first moment) in the port's names, ada_p /
    ada_rt."""
    mesh = jmake_mesh(2)
    repl, dsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    jinit, jg, jd, jr = jsteps.make_ae_steps(jlosses, None, aug_fn=jada.augment)
    state = jax.device_put(jinit(jax.random.PRNGKey(0), gen, disc), repl)
    bi = {"img": jax.device_put(jnp.asarray(img), dsh)}
    bv = {"vid": jax.device_put(jnp.asarray(vid), dsh)}
    key = jax.random.PRNGKey(1)
    out = []

    def record(kind, mode, m, opt, module):
        out.append({"kind": kind, "mode": mode, "metrics": {k: float(v) for k, v in m.items()},
                    "grads": _port_tree(module, opt[0].mu),
                    "ada_p": float(state.ada_p), "ada_rt": float(state.ada_rt)})

    g = jax.jit(lambda s, b, r: jg(s, b, r, "img"))
    d = jax.jit(lambda s, b, f, r: jd(s, b, f, r, "img"))
    r1 = jax.jit(lambda s, b, r: jr(s, b, "img", r))
    gv = jax.jit(lambda s, b, r: jg(s, b, r, "vid"))
    dv = jax.jit(lambda s, b, f, r: jd(s, b, f, r, "vid"))

    def split_fakes(fn, batch):
        return jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=dsh),
            jax.eval_shape(fn, state, batch, key)[2])

    # the five programs compiled at once on threads (XLA compiles outside
    # the GIL) for the state replicated and the batch and the G step's fakes
    # split over "data", which each call's inputs are put in
    fake, fakev = split_fakes(g, bi), split_fakes(gv, bv)
    with ThreadPoolExecutor(5) as pool:
        g, d, r1, gv, dv = pool.map(lambda fn_args: fn_args[0].lower(*fn_args[1]).compile(
            compiler_options=FAST_COMPILE), [(g, (state, bi, key)), (d, (state, bi, fake, key)),
                                             (r1, (state, bi, key)), (gv, (state, bv, key)),
                                             (dv, (state, bv, fakev, key))])
    state, m, fake = g(state, bi, key)
    record("g", "img", m, state.opt_g, ae_mod)
    state, m = d(jax.device_put(state, repl), bi, jax.device_put(fake, dsh), key)
    record("d", "img", m, state.opt_d, disc_mod)
    state, m = r1(jax.device_put(state, repl), bi, key)
    record("r1", "img", m, state.opt_d, disc_mod)
    state, m, fakev = gv(jax.device_put(state, repl), bv, key)
    record("g", "vid", m, state.opt_g, ae_mod)
    state, m = dv(jax.device_put(state, repl), bv, jax.device_put(fakev, dsh), key)
    record("d", "vid", m, state.opt_d, disc_mod)
    return out


def _jax_transformer(gparams, codes, tmodel):
    """Two steps of the JAX step on ``make_mesh(2)``: metrics and the second
    step's gradient (from the first moments) in the port's names."""
    cfg = jcfg.TransformerConfig(**R.GPT_KW)
    jtr = JTT(cfg, dtype=F32)
    mesh = jmake_mesh(2)
    init, step = jsteps.make_transformer_step(jtr, cfg, 10)
    state = jax.device_put(init(gparams), NamedSharding(mesh, P()))
    metrics, mus, compiled = [], [], None
    for code in codes:
        batch = {"code": jax.device_put(jnp.asarray(code), NamedSharding(mesh, P("data")))}
        if compiled is None:  # XLA's quick options (torch_parity.FAST_COMPILE)
            compiled = step.lower(state, batch).compile(compiler_options=FAST_COMPILE)
        state, m = compiled(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        mus.append(state.opt[0].mu)
    b1 = cfg.beta1
    g2 = jax.tree_util.tree_map(lambda a, b: (b - b1 * a) / (1 - b1), *mus)
    return {"metrics": metrics, "grads": _port_tree(tmodel, g2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory, few_threads):
    acfg = jcfg.AutoencoderConfig(**R.AE_ADA_KW)
    jlosses, gen, disc = _jax_ae(acfg)
    jtr = JTT(jcfg.TransformerConfig(**R.GPT_KW), dtype=F32)
    gparams = jax_params(lambda k: jtr.init(k, batch=2), seed=3)
    img, vid, codes = _batches()
    _, gcfg = R.port_cfgs()
    core = GPTCore(dataclasses.replace(gcfg, n_layer=4))
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        for p in core.parameters():
            p.normal_(0.0, 0.2, generator=g)
    emb = np.random.RandomState(8).randn(4, 12, gcfg.n_embd).astype(np.float32)
    inputs = {"ae_gen": _flat(gen), "ae_disc": _flat(disc), "img": img, "vid": vid,
              "gpt": _flat(gparams), "codes": codes, "core": core.state_dict(), "emb": emb}
    tmp = tmp_path_factory.mktemp("ranks")
    inputs["gen_flags"] = R.tiny_generate_run(str(tmp / "gen"))
    join2 = R.launch(2, str(tmp / "w2"), inputs)
    join4 = R.launch(4, str(tmp / "w4"), inputs)

    # meanwhile, the references
    ae_mod, disc_mod = _port_ae(gen, disc)
    ref = {"jax_ae": _jax_ae_sequence(jlosses, gen, disc, img, vid, ae_mod, disc_mod)}
    from ccvs_tpu_torch.models.transformer import TokenTransformer

    tmodel = TokenTransformer(gcfg, dtype=torch.float32, device="cpu").model
    ref["jax_tr"] = _jax_transformer(gparams, codes, tmodel)
    ref["dp1"] = R.transformer_steps(None, gcfg, inputs["gpt"], codes)
    embt = torch.from_numpy(emb).requires_grad_(True)
    out = core(embt)
    (out ** 2).sum().backward()
    ref["core"] = {"out": out.detach(), "emb_grad": embt.grad,
                   "grads": {n: p.grad for n, p in core.named_parameters()}}
    mp = pytest.MonkeyPatch()
    try:
        R.seeded_datasets(mp.setattr)
        ref["trainers"] = _dp1_trainers(str(tmp / "dp1"))
    finally:
        mp.undo()
    ref["generate"] = {seed: R.generate_files(inputs["gen_flags"], str(tmp / f"gen_dp1_{seed}"),
                                              "--seed", str(seed)) for seed in (0, 1)}
    return {"w2": join2(), "w4": join4(), "ref": ref, "tmp": tmp}


def _dp1_trainers(path):
    import os

    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    cfg = R.trainer_cfg(os.path.join(path, "ae"))
    st = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu").run(n_iter=2)
    out = {"ae_gen": R._trainer_params(st, "gen"), "ae_disc": R._trainer_params(st, "disc")}
    base = R.trainer_cfg(os.path.join(path, "tr"))
    cfg = base.replace(data=dataclasses.replace(base.data, vid_len=2, load_vid_len=None))
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(0)
    out["gpt"] = R._trainer_params(
        TransformerTrainer(cfg, ae, dtype=torch.float32, device="cpu").run(n_iter=2), "params")
    out["cfg"], out["ae"] = cfg, ae
    return out


def close(got, want, rtol, rel_atol, scale=None, what=""):
    got, want = to_np(got), to_np(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rel_atol * max(scale, 1e-30),
                               err_msg=what)


def _same_tree(got, want, rtol, rel_atol, scale=None):
    assert set(got) == set(want), set(got) ^ set(want)
    s = max(float(np.abs(to_np(v)).max()) for v in want.values()) if scale is None else scale
    for k in want:
        close(got[k], want[k], rtol, rel_atol, s, k)


# ---------------------------------------------------------------- the mesh


def test_jax_minibatch_stddev_is_the_global_batch_s():
    """What the JAX package computes at ``make_mesh(2)``: the image
    discriminator of a batch whose stddev groups ({0, 4}, {1, 5}, ...)
    straddle the two devices equals the unsharded call (GSPMD keeps the
    global groups; the docstring's "per-device batch" does not hold) and
    differs from the two halves called alone."""
    cfg = jcfg.AutoencoderConfig(**R.AE_KW)
    di = jdisc.ImageDiscriminator(cfg)
    params = jax_params(lambda k: di.init(k, jnp.zeros((2, 8, 8, 3)))["params"], seed=5)
    x = jnp.asarray(np.random.RandomState(0).randn(8, 8, 8, 3).astype(np.float32))
    mesh = jmake_mesh(2)
    apply = jax.jit(lambda p, v: di.apply({"params": p}, v))
    whole = np.asarray(apply(params, x))
    sharded = np.asarray(apply(jax.device_put(params, NamedSharding(mesh, P())),
                               jax.device_put(x, NamedSharding(mesh, P("data")))))
    halves = np.concatenate([np.asarray(apply(params, x[:4])), np.asarray(apply(params, x[4:]))])
    np.testing.assert_allclose(sharded, whole, rtol=1e-5, atol=1e-6)
    assert np.abs(halves - whole).max() > 1e-3


def test_shard_batch_and_host_local_rows():
    """``shard_batch`` keeps a data rank's block and refuses a leading dim
    that does not divide; ``host_local_rows`` without a mesh is every row."""
    from ccvs_tpu_torch.parallel import mesh as pm

    class Sub:
        def __init__(self, r, n):
            self.r, self.n = r, n

        def size(self):
            return self.n

        def get_local_rank(self):
            return self.r

    fake = {"data": Sub(1, 2)}
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(pm.shard_batch(fake, {"x": x})["x"], x[3:])
    assert pm.shard_batch(fake, {"d": np.int32(3)})["d"] == 3
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard_batch(fake, np.zeros((5, 2)))
    rows, ids = pm.host_local_rows(torch.from_numpy(x), fake)
    np.testing.assert_array_equal(ids, np.arange(6, 12))
    rows, ids = pm.host_local_rows(x)
    np.testing.assert_array_equal(ids, np.arange(6))


def test_placements_and_fsdp_specs():
    """``data_sharding`` / ``replicate`` are the batch's and the weights'
    placements; ``fsdp_param_specs`` splits every parameter on dim 0."""
    from torch.distributed.tensor import Replicate, Shard

    from ccvs_tpu_torch.models.transformer import TokenTransformer
    from ccvs_tpu_torch.parallel import data_sharding, fsdp_param_specs, replicate

    assert data_sharding(None) == (Shard(0), Replicate())
    assert replicate(None) == (Replicate(), Replicate())
    _, gcfg = R.port_cfgs()
    gpt = TokenTransformer(gcfg, dtype=torch.float32, device="cpu").model
    specs = fsdp_param_specs(gpt)
    assert specs.keys() == dict(gpt.named_parameters()).keys() and set(specs.values()) == {0}


def test_loader_blocks_are_the_one_process_batches():
    """A data rank's loader batch is its block of the one-process batch:
    the ranks' batches end to end are that batch, padded by wrapping."""
    from ccvs_tpu_torch.data import PrefetchLoader

    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"i": np.asarray([i])}

    one = [b["i"] for b in PrefetchLoader(Items(), 4, num_workers=1, seed=3, host_shard=None,
                                          drop_last=False)]
    two = [[b["i"] for b in PrefetchLoader(Items(), 4, num_workers=1, seed=3,
                                           host_shard=(r, 2), drop_last=False)] for r in range(2)]
    assert len(two[0]) == len(two[1]) == 2
    np.testing.assert_array_equal(np.concatenate([two[0][0], two[1][0]]), one[0])
    idx = np.arange(7)
    np.random.RandomState(3).shuffle(idx)
    got = np.concatenate([two[0][1], two[1][1]])[:, 0]
    np.testing.assert_array_equal(got, np.resize(idx, 8)[4:])


# ---------------------------------------------------------------- DP-2 vs JAX


STEPS = ["g img", "d img", "r1 img", "g vid", "d vid"]


@pytest.mark.parametrize("i", range(len(STEPS)), ids=STEPS)
def test_dp2_ae_step_matches_jax_make_mesh_2(world, i):
    """The autoencoder's image G, D and R1 steps with ADA, then its video G
    and D steps, all with the feature discriminator, at DP-2 (each rank 4
    of the 8 images and 4 of the 8 clips: every stddev group of the image,
    video and feature discriminators straddles the ranks) against the JAX
    package's steps on ``make_mesh(2)`` from the same weights and global
    batch: every metric within rtol 1e-4 (the global batch's), each rank's
    averaged gradient within rtol 1e-4 plus 1e-4 of the step's largest
    entry, and ``ada_p`` / ``ada_rt`` (the controller's statistic over the
    global batch)."""
    want = world["ref"]["jax_ae"][i]
    for rank in range(2):
        got = world["w2"][rank]["ae_steps"][i]
        assert (got["kind"], got["mode"]) == (want["kind"], want["mode"])
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), (rank, k)
        _same_tree(got["grads"], want["grads"], 1e-4, 1e-4)
        assert got["ada_p"] == pytest.approx(want["ada_p"], abs=1e-9)
        assert got["ada_rt"] == pytest.approx(want["ada_rt"], abs=1e-6)


def test_dp2_transformer_step_matches_jax_make_mesh_2(world):
    """Two transformer steps at DP-2 against the JAX step on
    ``make_mesh(2)``: ``nll`` and ``gnorm`` within rtol 1e-5, the second
    step's averaged gradient within rtol 1e-4 plus 1e-5 of its largest."""
    want = world["ref"]["jax_tr"]
    for rank in range(2):
        got = world["w2"][rank]["transformer_dp"]
        for gm, jm in zip(got["metrics"], want["metrics"]):
            for k in ("nll", "gnorm"):
                assert gm[k] == pytest.approx(jm[k], rel=1e-5), k
        _same_tree(got["grads"], want["grads"], 1e-4, 1e-5)


# ---------------------------------------------------------------- split GPTs vs DP-1


@pytest.mark.parametrize("kind", ["fsdp", "tp", "sp", "tpxsp", "dp2xtp2", "fsdp2xtp2",
                                  "dp2xtp2xsp2"])
def test_split_transformer_steps_match_dp1(world, kind):
    """FSDP-2, TP-2, SP-2, TP-2 with the tokens split too (the trainer's TP x
    SP), and on 4 ranks DP-2 x TP-2, FSDP-2 x TP-2 and DP-2 x TP-2 x SP-2,
    against the one-process step on the same weights and batches: each
    step's ``nll`` and ``gnorm`` within rtol 1e-5, the second step's whole
    gradient within rtol 1e-4 plus 1e-5 of its largest, the parameters
    after it within rtol 2e-3 and atol 2e-4 (``tests/test_parallel.py``'s);
    under FSDP x TP each rank holds a quarter of the largest parameter."""
    ref = world["ref"]["dp1"]
    ranks = world["w4"] if kind.startswith(("dp2", "fsdp2")) else world["w2"]
    for rank, out in enumerate(ranks):
        got = out[kind]
        for gm, rm in zip(got["metrics"], ref["metrics"]):
            for k in ("nll", "gnorm"):
                assert gm[k] == pytest.approx(rm[k], rel=1e-5), (rank, k)
        _same_tree(got["grads"], ref["grads"], 1e-4, 1e-5)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(to_np(got["params"][k]), to_np(v), rtol=2e-3, atol=2e-4)
        if kind == "fsdp2xtp2":
            assert got["share"] == 0.5  # of the tensor-parallel shard: 1/4 of the whole


def test_fsdp2_keeps_parameters_and_moments_split(world):
    """After two FSDP-2 steps the largest parameter and both its AdamW
    moments hold half their entries on each rank."""
    for out in world["w2"]:
        split = out["fsdp"]["split"]
        assert split["param"] == split["exp_avg"] == split["exp_avg_sq"] == 0.5, split


def test_pp2_core_matches_gpt_core(world):
    """``pipeline_core`` over 2 stages (2 microbatches) against
    ``GPTCore``: the output and the input's gradient on every stage within
    1e-4 of their largest entries, and each stage's blocks' gradients and the
    final LayerNorm's within 1e-4 of the largest of them (the keys' biases
    have a zero gradient, which rounding leaves at ~1e-9)."""
    ref = world["ref"]["core"]
    for out in world["w2"]:
        got = out["pp"]
        close(got["out"], ref["out"], 0, 1e-4)
        close(got["emb_grad"], ref["emb_grad"], 0, 1e-4)
        assert got["grads"]
        scale = max(float(ref["grads"][k].abs().max()) for k in got["grads"])
        for k, g in got["grads"].items():
            close(g, ref["grads"][k], 0, 1e-4, scale=scale, what=k)


# ---------------------------------------------------------------- trainers


@pytest.mark.parametrize("part", ["ae_gen", "ae_disc", "gpt"])
def test_dp2_trainers_match_dp1(world, part):
    """The AE trainer's and the transformer trainer's 2-iteration ``run`` at
    DP-2 against DP-1 (``tests/test_parallel.py:71`` and ``:84``): the same
    parameters within rtol 2e-3, atol 2e-4, on both ranks."""
    ref = world["ref"]["trainers"][part]
    for out in world["w2"]:
        got = out["trainers"][part]
        for k, v in ref.items():
            np.testing.assert_allclose(to_np(got[k]), to_np(v), rtol=2e-3, atol=2e-4, err_msg=k)


def test_dp2_generate_writes_what_one_process_writes(world):
    """``cli.py generate --distributed`` at DP-2 (each rank 2 of the batch's
    4 clips; a class label drawn and every token sampled) writes, between
    its ranks, the files one process writes from the same seed: each rank
    its rows, named by global index, each file once, with at most 1 % of
    the frames' 8-bit entries one level apart (the decoders' sums at batch 2
    and 4 may round apart) and none further. Another seed's tokens decode
    to fake clips with over 10 % of their entries changed (this random
    decoder's frames are nearly flat, so the levels move little)."""
    from ccvs_tpu_torch.utils.video_io import read_video

    def diff(a, b):
        path = world["tmp"] / "clip.avi"
        out = []
        for data in (a, b):
            path.write_bytes(data)
            out.append(read_video(str(path)).astype(np.int16))
        return np.abs(out[0] - out[1])

    ref = world["ref"]["generate"]
    got = [out["generate"] for out in world["w2"]]
    assert not set(got[0]) & set(got[1])
    assert set(got[0]) | set(got[1]) == set(ref[0]) and len(ref[0]) == 12
    for mine in got:
        for k, data in mine.items():
            d = diff(data, ref[0][k])
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, (k, d.max(), (d > 0).mean())
    fakes = [k for k in ref[0] if "/fake/" in k]
    assert len(fakes) == 4
    for k in fakes:
        assert (diff(ref[1][k], ref[0][k]) > 0).mean() > 0.1, k


def test_dp_checkpoints_resume_in_one_process(world):
    """Rank 0 writes the checkpoints whole: the DP-2 transformer run's and
    the FSDP-2 run's latest load into a one-process trainer, hold the
    ranks' final parameters, and resume to a third iteration; the FSDP-2
    run's checkpoint resumed under FSDP-2 and under TP-2 takes the same
    third step (rtol 2e-3, atol 2e-4); the DP-2 AE run's latest holds its
    generator."""
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    tmp, ref = world["tmp"] / "w2", world["ref"]["trainers"]
    ae_tree = CheckpointManager(str(tmp / "ae_dp2" / "checkpoints" / "par")).load("qvid")
    for k, v in world["w2"][0]["trainers"]["ae_gen"].items():
        assert torch.equal(ae_tree["gen"][k], v), k
    for run, key in (("tr_dp2", "gpt"), ("tr_fsdp2", "gpt_fsdp")):
        path = tmp / run
        tree = CheckpointManager(str(path / "checkpoints" / "par")).load("transformer")
        assert tree["step"] == 2
        for k, v in world["w2"][0]["trainers"][key].items():
            assert torch.equal(tree["params"][k], v), (run, k)
        cfg = ref["cfg"].replace(save_path=str(path))
        mp = pytest.MonkeyPatch()
        try:
            R.seeded_datasets(mp.setattr)
            st = TransformerTrainer(cfg, ref["ae"], dtype=torch.float32, device="cpu").run(
                n_iter=3, resume=True)
        finally:
            mp.undo()
        assert st.step == 3
        if run == "tr_fsdp2":
            third = {k: v.detach() for k, v in st.params.named_parameters()}
            for split in ("resume_fsdp2", "resume_tp2"):
                for out in world["w2"]:
                    step, got = out["trainers"][split]
                    assert step == 3 and got.keys() == third.keys()
                    for k, v in third.items():
                        np.testing.assert_allclose(to_np(got[k]), to_np(v), rtol=2e-3,
                                                   atol=2e-4, err_msg=f"{split} {k}")


def test_sync_triggered_agrees_across_ranks(world):
    """``sync_triggered(every=2)``: rank 1's flag, set before its third
    call, reaches both ranks at the same call (the third, a sync), and only
    rank 1's local flag is set."""
    seen = [out["sync"]["seen"] for out in world["w2"]]
    assert seen[0] == seen[1] == [False, False, True, True, True, True]
    assert [out["sync"]["local"] for out in world["w2"]] == [False, True]


def test_sync_triggered_one_process_is_the_local_flag():
    from ccvs_tpu_torch.utils.preemption import PreemptionGuard

    g = PreemptionGuard()
    assert g.sync_triggered() is False
    g.trigger()
    assert g.sync_triggered() is True


def test_dryrun_at_4_ranks(world):
    """``run_tiny_multichip_step`` at 4 ranks: DP, FSDP, DP x TP, DP x SP and
    the pipeline, each rank printing the same line."""
    lines = [out["dryrun"] for out in world["w4"]]
    assert len(set(lines)) == 1 and lines[0].startswith("dryrun_multichip ok: "), lines
    for key in ("nll_fsdp=", "nll_dpxtp=", "nll_dpxsp=", "pp2=ok"):
        assert key in lines[0]
