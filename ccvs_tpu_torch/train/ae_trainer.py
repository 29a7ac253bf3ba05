"""Frame-autoencoder training (counterpart of ``ccvs_tpu/train/ae_trainer.py``,
the reference's ``helpers/frame_autoencoder_trainer.py``): alternating G and
D steps on image batches, a video G and D step every ``vid_step_every``
iterations, lazy R1 every ``d_reg_every``, the generator's EMA after each of
its steps, a held-out reconstruction PSNR, rolling latest and periodic
checkpoints, resume and SIGTERM. Also what the latent-stage trainers share
with it: an endless loader and the move of a numpy batch to the device.

The autoencoder and the discriminators compute in ``dtype`` (bf16 by
default, as the JAX package's trainer) and hold fp32 parameters. Each
iteration launches kernel K1 twice on CUDA (the image and the video G
steps' quantization), and once more for each reconstruction of the eval.

With ``mesh`` (``parallel/mesh.py``) the trainers run data-parallel, one
process a device: each process loads its block of every global batch, the
steps average the gradients over the data axis, and rank 0 alone logs and
writes the checkpoints, in the format one process writes.
"""

import dataclasses
import os
import time

import numpy as np
import torch

from ccvs_tpu_torch.data import FoldCycler, PrefetchLoader, create_dataset
from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.models.autoencoder import FrameAutoencoder
from ccvs_tpu_torch.nn.discriminators import (FeatureDiscriminator, ImageDiscriminator,
                                              VideoDiscriminator)
from ccvs_tpu_torch.nn.layers import init_equalized
from ccvs_tpu_torch.nn.vgg import make_vgg
from ccvs_tpu_torch.parallel.mesh import DataAxis, mesh_device, put_batch, replicate_tree
from ccvs_tpu_torch.train.ada import augment
from ccvs_tpu_torch.train.ae_losses import AELosses
from ccvs_tpu_torch.train.states import iteration_generator
from ccvs_tpu_torch.train.steps import make_ae_steps
from ccvs_tpu_torch.utils import profiling
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from ccvs_tpu_torch.utils.logging import Logger
from ccvs_tpu_torch.utils.preemption import PreemptionGuard


def cycle_loader(loader):
    while True:
        yield from loader


def to_device(batch, device):
    """Host batch (numpy arrays or tensors) -> tensors on ``device``."""
    return put_batch(None, batch, device)


def trainer_device(device, mesh):
    """The device of a trainer given ``device`` and ``mesh``: the mesh's
    device of this process, which ``device`` must name where given."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's ({dev})")
    return dev


def host_shard(mesh):
    """The loaders' ``host_shard`` on ``mesh``: this process's data rank and
    the data axis's size (the model axis's ranks load the same rows)."""
    if mesh is None:
        return "auto"
    return mesh["data"].get_local_rank(), mesh["data"].size()


def is_main_process():
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class FrameAutoencoderTrainer:
    """Trains the autoencoder of ``cfg.ae`` with its discriminators (image
    ``di`` with ``use_di``, video ``dv`` with ``use_dv``, latent ``df`` with
    ``use_df``) and the perceptual loss of VGG19 (the weights of
    ``vgg_npz``, or seeded random filters), on ``device`` (default: the
    GPU). With ``use_aug`` the image discriminator sees the adaptive
    augmentation (:func:`~ccvs_tpu_torch.train.ada.augment`); with
    ``use_layout`` the autoencoder has its layout twins and the batches
    carry ``layout`` maps."""

    def __init__(self, cfg, vgg_npz=None, dtype=torch.bfloat16, device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = trainer_device(device, mesh)
        acfg = cfg.ae
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.ae = FrameAutoencoder(acfg, device=self.device, **kw)
        with self.device:
            self.di = ImageDiscriminator(acfg, **kw) if acfg.use_di else None
            self.dv = VideoDiscriminator(acfg, acfg.vid_len, **kw) if acfg.use_dv else None
            self.df = FeatureDiscriminator(acfg, **kw) if acfg.use_df else None
        self.vgg = None
        if acfg.use_vgg_img or acfg.use_vgg_vid:
            self.vgg = make_vgg(vgg_npz, seed=cfg.seed, device=self.device)
        self.losses = AELosses(acfg, self.ae, self.di, self.dv, self.df, self.vgg)
        self.init_state, self.g_step, self.d_step, self.r1_step = make_ae_steps(
            self.losses, aug_fn=augment if acfg.use_aug else None, data_axis=DataAxis.of(mesh))
        self.preempted = False

    def init_params(self, seed=None):
        """Seeded parameters: the autoencoder's from ``seed``, the
        discriminators' (flax's initializers) from ``seed + 1``."""
        seed = self.cfg.seed if seed is None else seed
        self.ae.init(seed)
        g = torch.Generator(device=self.device).manual_seed(seed + 1)
        for d in (self.di, self.dv, self.df):
            if d is not None:
                init_equalized(d, g)

    def make_loaders(self):
        """``(img_loader, vid_loader)``: image groups (``batch_size_img``
        images, ``n_consecutive_img`` plus the elastic view a group), over
        ``num_folds_train`` folds when set; clips of ``ae.vid_len`` frames
        from ``extra_data`` when set, else from ``data`` (None when that
        dataset has no sequences)."""
        cfg = self.cfg
        group = cfg.data.n_consecutive_img + (1 if cfg.data.load_elastic_view else 0)
        bs_img = max(1, cfg.data.batch_size_img // group)

        shard = host_shard(self.mesh)

        def make_img_loader(fold=None):
            ds = create_dataset(cfg.data, phase="train", load_vid=False, fold=fold)
            return PrefetchLoader(ds, bs_img, num_workers=cfg.data.num_workers, seed=cfg.seed,
                                  host_shard=shard)

        if cfg.data.num_folds_train:
            img_loader = FoldCycler(make_img_loader, cfg.data.num_folds_train,
                                    cfg.data.init_fold_train,
                                    random_fold=cfg.data.random_fold_train, seed=cfg.seed)
        else:
            img_loader = make_img_loader()
        vid_src = cfg.extra_data if cfg.extra_data is not None else cfg.data
        vid_loader = None
        if vid_src.is_seq:
            # the autoencoder's rollout is short (BAIR: 4 frames), not the
            # transformer's clip length
            vid_ds = create_dataset(dataclasses.replace(vid_src, vid_len=cfg.ae.vid_len),
                                    phase="train", load_vid=True)
            vid_loader = PrefetchLoader(vid_ds, vid_src.batch_size_vid,
                                        num_workers=vid_src.num_workers, seed=cfg.seed + 1,
                                        host_shard=shard)
        return img_loader, vid_loader

    @staticmethod
    @torch.no_grad()
    def rec_eval(ae, img):
        """``(rec, psnr)``: ``ae``'s reconstruction (fp32) of an image batch
        in [-1, 1] and its mean PSNR (peak-to-peak 2)."""
        rec = ae.reconstruct(img).float()
        mse = ((rec - img.float()) ** 2).mean(dim=(1, 2, 3))
        return rec, (10.0 * torch.log10(4.0 / mse.clamp_min(1e-10))).mean()

    def iteration(self, state, it, img_batch, vid_batch=None, generator=None):
        """One training iteration on device batches: the image G and D
        steps, R1 every ``d_reg_every``, then with ``vid_batch`` the video G
        and D steps and their R1. ``generator`` draws the context-drop mask
        and the image steps' augmentation. Returns ``(state, g_metrics,
        d_metrics, fake)``; ``state.step`` becomes ``it + 1``."""
        acfg = self.cfg.ae
        state, gm, fake = self.g_step(state, img_batch, "img", generator)
        dm = {}
        if self.di is not None or self.df is not None:
            state, dm = self.d_step(state, img_batch, fake, "img", generator)
        r1_now = acfg.d_reg_every and it % acfg.d_reg_every == 0
        if self.di is not None and r1_now:
            state, rm = self.r1_step(state, img_batch, "img", generator)
            gm.update(rm)
        if vid_batch is not None:
            state, gmv, fakev = self.g_step(state, vid_batch, "vid", generator)
            if self.dv is not None or self.df is not None:
                state, dmv = self.d_step(state, vid_batch, fakev, "vid")
                dm.update(dmv)
            if self.dv is not None and r1_now:
                state, rmv = self.r1_step(state, vid_batch, "vid")
                gmv.update(rmv)
            gm.update(gmv)
        state.step = it + 1
        return state, gm, dm, fake

    def run(self, n_iter=None, resume=False, eval_every=0, snapshot_every=0,
            serialize_steps=False, profile_dir=None):
        """Train from a seeded init (or, with ``resume``, the latest
        checkpoint) to ``n_iter`` (default ``cfg.n_iter``): scalars to
        ``logs/<name>/metrics.jsonl``; every ``eval_every`` iterations the
        reconstruction PSNR of a fixed valid batch (``rec_psnr``: the EMA's,
        ``rec_psnr_raw``: the raw generator's) and the augmentation
        probability ``ada_p``, with PNG snapshots every
        ``snapshot_every`` (PIL); a latest checkpoint every
        ``save_latest_freq`` iterations, at the end and on SIGTERM (which
        sets ``self.preempted``), a kept one every ``save_freq``; with
        ``cfg.npz_mirror`` the raw generator into that npz as the JAX
        package's ``ae_gen`` tree. ``serialize_steps`` waits for each
        iteration's device work. ``profile_dir``: a ``torch.profiler`` trace
        of iterations ``start + 10 .. start + 12`` there. The image grids
        ``fake_img`` / ``real_img`` go to tensorboard every ``log_freq``."""
        from ccvs_tpu_torch.weights import export_params

        cfg, acfg = self.cfg, self.cfg.ae
        n_iter = n_iter or cfg.n_iter
        run_dir = os.path.join(cfg.save_path, "checkpoints", cfg.name)
        log_path = os.path.join(cfg.save_path, "logs", cfg.name)
        mirror = None
        if cfg.npz_mirror:
            mirror = (cfg.npz_mirror, lambda tree: {"ae_gen": export_params(self.ae)})
        main = is_main_process()
        ckpt = CheckpointManager(run_dir, async_save=cfg.async_ckpt, npz_mirror=mirror)
        if main:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
        logger = Logger(log_path, is_main=main, imagenet_norm=cfg.data.imagenet_norm)

        self.init_params()
        if self.mesh is not None:
            for m in (self.ae, self.di, self.dv, self.df):
                if m is not None:
                    replicate_tree(self.mesh, m)
        state = self.init_state()
        start = 0
        if resume:
            state = ckpt.load("qvid", "latest", target=state)
            start = state.step
        img_loader, vid_loader = self.make_loaders()
        img_iter = iter(cycle_loader(img_loader))
        vid_iter = iter(cycle_loader(vid_loader)) if vid_loader is not None else None
        eval_batch = None
        if eval_every:
            eval_cfg = dataclasses.replace(cfg.data, load_elastic_view=False, n_consecutive_img=1)
            eval_ds = create_dataset(eval_cfg, phase="valid", load_vid=False)
            eval_batch = torch.from_numpy(np.stack(
                [eval_ds[i]["img"] for i in range(min(16, len(eval_ds)))])).to(self.device)

        t0 = time.time()
        self.preempted = False
        eval_count = 0
        prof = None
        with PreemptionGuard() as guard:
            for it in range(start, n_iter):
                # a short capture window, as the JAX package's trainer takes
                if profile_dir and it == start + 10:
                    prof = profiling.start_trace()
                if prof is not None and it == start + 13:
                    profiling.stop_trace(prof, profile_dir, f"ae_iters_{it - 3}_{it - 1}")
                    prof = None
                img_batch = to_device(next(img_iter), self.device)
                vid_batch = None
                if vid_iter is not None and it % acfg.vid_step_every == 0:
                    vid_batch = to_device(next(vid_iter), self.device)
                state, gm, dm, fake = self.iteration(
                    state, it, img_batch, vid_batch, iteration_generator(cfg.seed, it, self.device))
                if serialize_steps and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                logger.log_scalars({**gm, **dm}, it, prefix="qvid_generator/")
                if cfg.log_freq and it % cfg.log_freq == 0:
                    logger.log_img("qvid_generator/fake_img", fake["img"][:16], 4, it,
                                   normalize=True)
                    logger.log_img("qvid_generator/real_img", img_batch["img"][:16], 4, it,
                                   normalize=True)
                    print(f"iter {it}: g={float(gm['g_loss']):.4f} "
                          f"d={float(dm.get('d_loss', 0.0)):.4f} "
                          f"({(time.time() - t0) / max(1, it - start + 1):.2f}s/it)")
                if eval_batch is not None and it % eval_every == 0:
                    eval_count += 1
                    rec, psnr = self.rec_eval(state.ema if acfg.use_ema else state.gen,
                                              eval_batch)
                    scalars, rec_raw = {"rec_psnr": psnr, "ada_p": state.ada_p}, None
                    if acfg.use_ema:
                        # the 0.999 EMA lags hundreds of iterations behind
                        rec_raw, scalars["rec_psnr_raw"] = self.rec_eval(state.gen, eval_batch)
                    logger.log_scalars(scalars, it, prefix="qvid_eval/")
                    if main and snapshot_every and (eval_count - 1) % max(
                            1, round(snapshot_every / eval_every)) == 0:
                        snap = os.path.join(log_path, "snapshots")
                        real = eval_batch[:8].float().cpu().numpy()
                        save_snapshot(snap, it, real, rec[:8].cpu().numpy())
                        if rec_raw is not None:
                            save_snapshot(snap, it, real, rec_raw[:8].cpu().numpy(),
                                          tag="rec_raw")
                if main and it % cfg.save_latest_freq == 0 and it > start:
                    ckpt.save("qvid", it, state.state_dict(), latest=True)
                if main and cfg.save_freq > 0 and it % cfg.save_freq == 0 and it > start:
                    ckpt.save("qvid", it, state.state_dict())
                if guard.sync_triggered():
                    if main:
                        ckpt.save("qvid", it + 1, state.state_dict(), latest=True)
                    print(f"[preemption] latest checkpoint written at iter {it + 1}; "
                          "exiting cleanly", flush=True)
                    self.preempted = True
                    break
        if prof is not None:
            profiling.stop_trace(prof, profile_dir, f"ae_iters_{start + 10}_{it}")
        if main and not self.preempted:
            ckpt.save("qvid", n_iter, state.state_dict(), latest=True)
        ckpt.wait()
        logger.close()
        return state


def save_snapshot(path, it, real, rec, tag="rec"):
    """PNG grid: the real frames above their reconstructions (PIL, imported
    here: only snapshots need it)."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    grid = np.concatenate([np.concatenate(list(x), axis=1) for x in (real, rec)], axis=0)
    u8 = np.clip((grid + 1) * 127.5, 0, 255).astype(np.uint8)
    Image.fromarray(u8).save(os.path.join(path, f"{tag}_{it:06d}.png"))


def load_ae_checkpoint(ckpt_dir, which="latest", raw=False, dtype=torch.bfloat16, device=None):
    """The autoencoder of a :class:`FrameAutoencoderTrainer` checkpoint in
    ``ckpt_dir`` (with the run's ``config.json``): the EMA weights, or the
    raw generator's with ``raw``, in a serving :class:`FrameAutoencoder` of
    ``dtype`` parameters on ``device``."""
    from ccvs_tpu_torch.config import Config

    cfg = Config.load(os.path.join(ckpt_dir, "config.json"))
    tree = CheckpointManager(ckpt_dir).load("qvid", which)
    ae = FrameAutoencoder(cfg.ae, dtype=dtype, device=device)
    ae.load_state_dict(tree["gen"] if raw else tree["ema"])
    return ae
