"""The rank side of ``tests/test_torch_parallel.py``: scenarios that each
process of a gloo group runs, and the launcher that spawns the group.

This module imports torch and ccvs_tpu_torch only: the ranks are started
with the ``spawn`` method (the test process holds JAX's threads) and import
it afresh. Each rank runs every scenario in order on one intra-op thread
and saves ``{scenario: result}`` with ``torch.save``; the launcher joins
every rank with a timeout, so that a collective that hangs fails the test
instead of the suite.
"""

import dataclasses
import os
import random
import shutil
import socket
import traceback

import torch
import torch.distributed as dist

from ccvs_tpu_torch import config as tcfg

# the configurations of tests/test_parallel.py (ccvs_tpu's multi-device tests)
AE_KW = dict(
    necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2),
    z_size=16, z_num=32, z_shape=(4, 4), max_dim=8,
    inter_p=0.5, skip_memory=2, skip_context=(1, 2),
    use_di=True, use_dv=True, use_vgg_img=False, use_vgg_vid=False,
    use_direct_recovery_img=True, use_direct_recovery_vid=True,
    slide_inter=True, n_consecutive_img=2, vid_len=3,
    load_elastic_view=False, elastic_corruption=False, d_reg_every=2,
    stddev_group=2,
)
# the adaptive augmentation on (aug_p 0: the controller moves ada_p), and
# the feature discriminator
AE_ADA_KW = dict(AE_KW, use_aug=True, aug_p=0.0, use_df=True)
GPT_KW = dict(z_num=32, z_len=32, z_chunk=16, num_blocks=2, cond_len=16,
              n_layer=2, n_head=2, n_embd=32, z_shape=(4, 4), emb_mode="temporal",
              lr=1e-3)
DATA_KW = dict(dataset="synthetic", max_dim=8, true_dim=32, vid_len=3,
               batch_size_img=8, batch_size_vid=8, n_consecutive_img=2, img_out_of_n=8,
               load_elastic_view=False, num_workers=1, load_vid_len=8)
# the global batches: 8 images (4 groups of 2), 8 clips (the video and
# feature discriminators' 2 groups of 4: {0, 2, 4, 6} and {1, 3, 5, 7}, each
# across both ranks of DP-2), 8 token rows
B_IMG, B_VID, B_CODE = 8, 8, 8


def port_cfgs():
    return (tcfg.AutoencoderConfig(**AE_ADA_KW), tcfg.TransformerConfig(**GPT_KW))


def trainer_cfg(save_path, gpt=None):
    """The trainers' tiny configuration (``tests/test_parallel.py``'s)."""
    data = tcfg.DataConfig(**DATA_KW)
    return tcfg.Config(name="par", save_path=save_path, data=data,
                       ae=tcfg.AutoencoderConfig(**AE_KW),
                       gpt=gpt or tcfg.TransformerConfig(**GPT_KW), n_iter=2,
                       save_latest_freq=100, log_freq=0)


class SeededItems:
    """A dataset whose items draw their augmentation from their index: the
    process-wide ``random`` stream the datasets draw from is re-seeded per
    item, so a process that loads any block of a batch draws what one
    process loading the whole batch draws."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        random.seed(1000 + int(i))
        return self.ds[i]


def seeded_datasets(monkeypatch_setattr):
    """Route the trainers' ``create_dataset`` through :class:`SeededItems`
    (``monkeypatch_setattr(module, name, value)``)."""
    from ccvs_tpu_torch.data import base
    from ccvs_tpu_torch.train import ae_trainer, transformer_trainer

    def create(*a, **kw):
        return SeededItems(base.create_dataset(*a, **kw))

    for mod in (ae_trainer, transformer_trainer):
        monkeypatch_setattr(mod, "create_dataset", create)


def _rows(x, rank, n):
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def _full_grads(model):
    from ccvs_tpu_torch.parallel.fsdp import full_tensor, tp_split

    return {n: full_tensor(p.grad, tp_split(model, n)).detach().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _full_params(model):
    """The whole parameters of a GPT, or of a ``TokenTransformer`` (names
    under ``model.``)."""
    from ccvs_tpu_torch.parallel.fsdp import full_tensor, tp_split

    gpt = getattr(model, "model", model)
    pre = "model." if gpt is not model else ""
    return {pre + n: full_tensor(p.detach(), tp_split(gpt, n)).clone()
            for n, p in gpt.named_parameters()}


def transformer_steps(mesh, cfg, weights, codes, tp=False):
    """Steps of ``make_transformer_step`` on the global token batches
    ``codes`` (this rank's rows of each) from the flat weights ``weights``,
    with ``tp`` the weights split over the model axis first (as the
    trainer splits them): each step's metrics, and the last step's whole
    gradients and the whole parameters after it."""
    from ccvs_tpu_torch.models.transformer import TokenTransformer
    from ccvs_tpu_torch.parallel.tp import shard_gpt_params
    from ccvs_tpu_torch.train.steps import make_transformer_step
    from ccvs_tpu_torch.weights import load_params

    tr = TokenTransformer(cfg, dtype=torch.float32, device="cpu")
    load_params(tr.model, weights)
    if tp:
        shard_gpt_params(mesh, tr.model)
    init, step = make_transformer_step(tr, cfg, n_iter=10, mesh=mesh)
    state = init()
    r, n = (0, 1) if mesh is None else (mesh["data"].get_local_rank(), mesh["data"].size())
    metrics = []
    for code in codes:
        state, m = step(state, {"code": _rows(torch.from_numpy(code).long(), r, n)})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": _full_grads(tr.model),
            "params": _full_params(tr.model), "state": state}


# ------------------------------------------------------------------ scenarios


def sc_ae_steps(ctx):
    """One iteration of ``make_ae_steps`` with ADA on, from the given
    weights, on this rank's block of the global batches."""
    from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
    from ccvs_tpu_torch.nn import discriminators as tdisc
    from ccvs_tpu_torch.parallel.mesh import DataAxis
    from ccvs_tpu_torch.train.ada import augment
    from ccvs_tpu_torch.train.ae_losses import AELosses
    from ccvs_tpu_torch.train.steps import make_ae_steps
    from ccvs_tpu_torch.weights import load_params

    mesh, inp = ctx["mesh"](2), ctx["inputs"]
    acfg, _ = port_cfgs()
    ae = FrameAutoencoder(acfg, dtype=torch.float32, device="cpu")
    load_params(ae, inp["ae_gen"])
    disc = torch.nn.ModuleDict({"di": tdisc.ImageDiscriminator(acfg),
                                "dv": tdisc.VideoDiscriminator(acfg, acfg.vid_len),
                                "df": tdisc.FeatureDiscriminator(acfg)})
    load_params(disc, inp["ae_disc"])
    init, g, d, r1 = make_ae_steps(AELosses(acfg, ae, disc["di"], disc["dv"], disc["df"]),
                                   aug_fn=augment, data_axis=DataAxis.of(mesh))
    state = init()
    r, n = mesh["data"].get_local_rank(), mesh["data"].size()
    img = {"img": _rows(torch.from_numpy(inp["img"]), r, n)}
    vid = {"vid": _rows(torch.from_numpy(inp["vid"]), r, n)}
    gen = torch.Generator().manual_seed(0)
    out = []

    def record(kind, mode, m, module):
        out.append({"kind": kind, "mode": mode, "metrics": {k: float(v) for k, v in m.items()},
                    "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                              if p.grad is not None},
                    "ada_p": float(state.ada_p), "ada_rt": float(state.ada_rt)})

    state, m, fake = g(state, img, "img", gen)
    record("g", "img", m, state.gen)
    state, m = d(state, img, fake, "img", gen)
    record("d", "img", m, state.disc)
    state, m = r1(state, img, "img", gen)
    record("r1", "img", m, state.disc)
    state, m, fakev = g(state, vid, "vid", gen)
    record("g", "vid", m, state.gen)
    state, m = d(state, vid, fakev, "vid")
    record("d", "vid", m, state.disc)
    return out


def tiny_generate_run(root):
    """A tiny sampled generation for ``cli.py generate``: a BAIR-layout
    valid split of 5 moving-square clips, a config whose generation draws a
    class label and samples every token, and seeded autoencoder and GPT
    checkpoints. Returns the command's flags."""
    import numpy as np
    from PIL import Image

    from ccvs_tpu_torch.models import FrameAutoencoder, TokenTransformer
    from ccvs_tpu_torch.utils.checkpoint import CheckpointManager

    ae = tcfg.AutoencoderConfig(
        necf=8, necf_mult=(1, 2), ndcf=8, ndcf_mult=(1, 2), z_size=16, z_num=32,
        z_shape=(8, 8), max_dim=16, inter_p=0.5, skip_memory=2, skip_context=(1, 2))
    gpt = tcfg.TransformerConfig(z_num=32, z_len=128, z_chunk=64, num_blocks=2, cond_len=64,
                                 n_layer=2, n_head=2, n_embd=32, z_shape=(8, 8), cat=True,
                                 num_lbl=3)
    data = tcfg.DataConfig(dataset="bairhd", dataroot=os.path.join(root, "bair"), max_dim=16,
                           true_dim=16, vid_len=2, batch_size_vid=4, num_workers=1)
    cfg = tcfg.Config(name="tiny", data=data, ae=ae, gpt=gpt, save_path=root)
    rng = np.random.RandomState(0)
    for c in range(5):
        d = os.path.join(data.dataroot, "original_frames_256", "test", f"{c:04d}")
        os.makedirs(d)
        x0, y0 = rng.randint(0, 8, 2)
        color = rng.randint(64, 255, 3)
        for t in range(3):
            f = np.full((16, 16, 3), 32, np.uint8)
            f[y0 + t:y0 + t + 4, x0 + t:x0 + t + 4] = color
            Image.fromarray(f).save(os.path.join(d, f"{t:02d}.png"))
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    m = FrameAutoencoder(ae, dtype=torch.float32, device="cpu").init(seed=0)
    ae_dir, gpt_dir = os.path.join(root, "ae"), os.path.join(root, "gpt")
    CheckpointManager(ae_dir).save("qvid", 1, {"gen": m.state_dict(), "ema": m.state_dict()},
                                   latest=True)
    with open(os.path.join(ae_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    tr = TokenTransformer(gpt, dtype=torch.float32, device="cpu").init(seed=1)
    CheckpointManager(gpt_dir).save("transformer", 1, {"params": tr.state_dict()}, latest=True)
    return ["--load-config", cfg_path, "--ae-ckpt", ae_dir, "--gpt-ckpt", gpt_dir,
            "--n-batches", "1", "--device", "cpu", "--dtype", "float32"]


def generate_files(flags, save_path, *extra):
    """``cli.py generate`` with ``flags`` into ``save_path``: ``{relative
    path: bytes}`` of every file it wrote."""
    from ccvs_tpu_torch import cli

    cli.main(["generate", *flags, "--save-path", save_path, *extra])
    out = {}
    for d, _, names in os.walk(os.path.join(save_path, "results")):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), save_path)] = f.read()
    return out


def sc_generate(ctx):
    """``cli.py generate --distributed`` at DP-2: the files this rank wrote
    (each rank into a directory of its own)."""
    return generate_files(ctx["inputs"]["gen_flags"],
                          os.path.join(ctx["tmp"], f"gen_dp2_rank{ctx['rank']}"),
                          "--distributed")


def sc_transformer_dp(ctx):
    _, gcfg = port_cfgs()
    res = transformer_steps(ctx["mesh"](2), gcfg, ctx["inputs"]["gpt"], ctx["inputs"]["codes"])
    return {k: v for k, v in res.items() if k != "state"}


def _trainer_params(state, part):
    return {k: v.detach().clone() for k, v in getattr(state, part).named_parameters()}


def sc_trainers(ctx):
    """The AE and transformer trainers' 2-iteration ``run`` at DP-2; the
    runs' checkpoint directories are under the scenario's tmp dir."""
    from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
    from ccvs_tpu_torch.train.ae_trainer import FrameAutoencoderTrainer
    from ccvs_tpu_torch.train.transformer_trainer import TransformerTrainer

    mesh = ctx["mesh"](2)
    seeded_datasets(setattr)
    cfg = trainer_cfg(os.path.join(ctx["tmp"], "ae_dp2"))
    st = FrameAutoencoderTrainer(cfg, dtype=torch.float32, device="cpu", mesh=mesh).run(n_iter=2)
    out = {"ae_gen": _trainer_params(st, "gen"), "ae_disc": _trainer_params(st, "disc")}
    base = trainer_cfg(os.path.join(ctx["tmp"], "tr_dp2"))
    cfg = base.replace(data=dataclasses.replace(base.data, vid_len=2, load_vid_len=None))
    ae = FrameAutoencoder(cfg.ae, dtype=torch.float32, device="cpu").init(0)
    ts = TransformerTrainer(cfg, ae, dtype=torch.float32, device="cpu", mesh=mesh).run(n_iter=2)
    out["gpt"] = _trainer_params(ts, "params")
    # FSDP through the trainer: a whole checkpoint written by rank 0
    fcfg = cfg.replace(save_path=os.path.join(ctx["tmp"], "tr_fsdp2"),
                       gpt=dataclasses.replace(cfg.gpt, fsdp=True))
    fs = TransformerTrainer(fcfg, ae, dtype=torch.float32, device="cpu", mesh=mesh).run(n_iter=2)
    out["gpt_fsdp"] = _full_params(fs.params)
    # that checkpoint resumed to a third iteration under FSDP-2 and under TP-2
    if ctx["rank"] == 0:
        for run in ("resume_fsdp2", "resume_tp2"):
            shutil.copytree(os.path.join(ctx["tmp"], "tr_fsdp2"), os.path.join(ctx["tmp"], run))
    dist.barrier()
    for run, c, m in (("resume_fsdp2", fcfg, mesh), ("resume_tp2", cfg, ctx["mesh"](2, 2))):
        st = TransformerTrainer(c.replace(save_path=os.path.join(ctx["tmp"], run)), ae,
                                dtype=torch.float32, device="cpu", mesh=m).run(n_iter=3,
                                                                               resume=True)
        out[run] = (st.step, _full_params(st.params))
    return out


def sc_fsdp(ctx):
    from ccvs_tpu_torch.parallel.fsdp import local_fraction

    _, gcfg = port_cfgs()
    gcfg = dataclasses.replace(gcfg, fsdp=True)
    res = transformer_steps(ctx["mesh"](2), gcfg, ctx["inputs"]["gpt"], ctx["inputs"]["codes"])
    state = res.pop("state")
    model = state.params.model
    name, biggest = max(model.named_parameters(), key=lambda kv: kv[1].numel())
    st = state.opt.opt.state[biggest]
    res["split"] = {"name": name, "param": local_fraction(biggest),
                    "exp_avg": local_fraction(st["exp_avg"]),
                    "exp_avg_sq": local_fraction(st["exp_avg_sq"])}
    return res


def _model_split(tp, sp=False, fsdp=False):
    """Transformer steps on a model axis of 2: the weights split over it
    (``tp``), the tokens (``sp``), both (the trainer's TP x SP), with FSDP
    over the data axis (``fsdp``)."""
    def run(ctx):
        _, gcfg = port_cfgs()
        gcfg = dataclasses.replace(gcfg, seq_parallel=sp, fsdp=fsdp)
        res = transformer_steps(ctx["mesh"](ctx["world"], 2), gcfg, ctx["inputs"]["gpt"],
                                ctx["inputs"]["codes"], tp=tp)
        state = res.pop("state")
        if fsdp:
            from ccvs_tpu_torch.parallel.fsdp import local_fraction

            res["share"] = local_fraction(max(state.params.parameters(), key=lambda p: p.numel()))
        return res
    return run


def sc_pp(ctx):
    """``pipeline_core`` over a model axis of 2 against ``GPTCore``: the
    output, the blocks' gradients and the input's gradient of ``sum(out**2)``."""
    from ccvs_tpu_torch.nn.gpt import GPTCore
    from ccvs_tpu_torch.parallel.pp import pipeline_core, shard_stage_params, stage_block_specs

    mesh = ctx["mesh"](2, 2)
    _, gcfg = port_cfgs()
    gcfg = dataclasses.replace(gcfg, n_layer=4)
    core = GPTCore(gcfg)
    core.load_state_dict(ctx["inputs"]["core"])
    shard_stage_params(mesh, core)
    emb = torch.from_numpy(ctx["inputs"]["emb"]).requires_grad_(True)
    out = pipeline_core(core, emb, mesh, n_micro=2)
    (out ** 2).sum().backward()
    s = mesh["model"].get_local_rank()
    mine = stage_block_specs(gcfg.n_layer, 2)[s]
    grads = {f"blocks.{i}.{n}": p.grad.clone() for i in mine
             for n, p in core.blocks[i].named_parameters()}
    grads.update({f"ln_f.{n}": p.grad.clone() for n, p in core.ln_f.named_parameters()})
    return {"out": out.detach(), "emb_grad": emb.grad.clone(), "grads": grads}


def sc_sync(ctx):
    """``sync_triggered(every=2)`` over 6 calls; rank 1 triggers before its
    third call."""
    from ccvs_tpu_torch.utils.preemption import PreemptionGuard

    guard = PreemptionGuard()
    seen = []
    for call in range(6):
        if dist.get_rank() == 1 and call == 2:
            guard.trigger()
        seen.append(guard.sync_triggered(every=2))
    return {"seen": seen, "local": guard.triggered}


def sc_dryrun(ctx):
    from ccvs_tpu_torch.train.dryrun import run_tiny_multichip_step

    return run_tiny_multichip_step(ctx["mesh"](ctx["world"]))


SCENARIOS = {2: {"ae_steps": sc_ae_steps, "transformer_dp": sc_transformer_dp,
                 "trainers": sc_trainers, "fsdp": sc_fsdp, "tp": _model_split(tp=True),
                 "sp": _model_split(tp=False, sp=True), "tpxsp": _model_split(tp=True, sp=True),
                 "pp": sc_pp, "sync": sc_sync, "generate": sc_generate},
             4: {"dp2xtp2": _model_split(tp=True),
                 "fsdp2xtp2": _model_split(tp=True, fsdp=True),
                 "dp2xtp2xsp2": _model_split(tp=True, sp=True),
                 "dryrun": sc_dryrun}}


# ------------------------------------------------------------------ launcher


def _rank_main(rank, world, port, tmp, inputs_path):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from ccvs_tpu_torch.parallel.mesh import init_distributed, make_mesh

    results = {}
    try:
        init_distributed("cpu")
        meshes = {}

        def mesh(n, model=1):
            if (n, model) not in meshes:
                meshes[n, model] = make_mesh(n, model_parallel=model, device="cpu")
            return meshes[n, model]

        inputs = torch.load(inputs_path, weights_only=False)
        ctx = {"mesh": mesh, "inputs": inputs, "tmp": tmp, "world": world, "rank": rank}
        for name, fn in SCENARIOS[world].items():
            results[name] = fn(ctx)
            dist.barrier()
    except BaseException:
        results["error"] = traceback.format_exc()
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    if "error" not in results:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, tmp, inputs, timeout=240):
    """Spawn ``world`` ranks that run ``SCENARIOS[world]`` on ``inputs``;
    returns ``[rank results]``. Starts them and returns a joiner, so that
    the caller can work while they run: ``join()`` waits (at most
    ``timeout`` seconds, then kills them and raises)."""
    import multiprocessing as mp
    import time

    os.makedirs(tmp, exist_ok=True)
    inputs_path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, inputs_path)
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, tmp, inputs_path), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    t0 = time.monotonic()

    def join():
        for p in procs:
            p.join(max(1.0, timeout - (time.monotonic() - t0)))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        outs = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            outs.append(torch.load(path, weights_only=False) if os.path.exists(path)
                        else {"error": f"rank {r} wrote no result"})
        errors = [o["error"] for o in outs if "error" in o]
        if hung or errors:
            raise RuntimeError(f"{len(hung)} of {world} ranks hung past {timeout} s; "
                               + "\n".join(errors))
        return outs

    return join
