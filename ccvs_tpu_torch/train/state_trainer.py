"""State-estimator and STFT-autoencoder training (counterpart of
``ccvs_tpu/train/state_trainer.py``): regression of the states from the
frozen autoencoder's latents, with the scalar quantizer's VQ loss, periodic
evaluation and best-checkpoint tracking; and the audio autoencoder of the
drums model, on spectrogram patches with the perceptual loss.
"""

import os

import numpy as np
import torch

from ccvs_tpu_torch.data import PrefetchLoader, create_dataset
from ccvs_tpu_torch.device import resolve_device
from ccvs_tpu_torch.models.state_model import StateModel
from ccvs_tpu_torch.models.stft_model import StftModel
from ccvs_tpu_torch.nn.vgg import make_vgg
from ccvs_tpu_torch.train.ae_trainer import cycle_loader, to_device
from ccvs_tpu_torch.train.states import make_adam
from ccvs_tpu_torch.train.steps import make_simple_step
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from ccvs_tpu_torch.utils.logging import Logger
from ccvs_tpu_torch.utils.preemption import PreemptionGuard


class StateEstimatorTrainer:
    """``helpers/state_estimator_trainer.py:19-167``: trains a
    :class:`StateModel` of ``cfg.state`` on the latents of the frozen
    autoencoder ``ae`` (on ``device``, default the GPU) with Adam. Each step
    launches K1 twice on CUDA: the frozen encode, and the state quantizer,
    whose codebook takes its gradient through the gather."""

    def __init__(self, cfg, ae, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if ae.device != self.device:
            raise ValueError(f"the autoencoder is on {ae.device}, the trainer on {self.device}")
        self.ae = ae
        self.model = StateModel(cfg.state, device=self.device)
        s = cfg.state
        self.init_state, self.step = make_simple_step(
            self.loss_fn, lambda m: make_adam(m.parameters(), s.lr, s.beta1, s.beta2,
                                              s.weight_decay))
        self.preempted = False

    @torch.no_grad()
    def latents(self, img):
        """Images ``(B, H, W, 3)`` -> the frozen encode's quantized latents."""
        return self.ae.embed_code(self.ae.encode(img)["code"])

    def loss_fn(self, model, batch):
        return model.loss(self.latents(batch["img"]), batch["state"])

    @torch.no_grad()
    def evaluate(self, model, loader, max_batches=8):
        """Mean squared error of the estimates over up to ``max_batches``
        batches of ``loader``."""
        errs = []
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            b = to_device(batch, self.device)
            pred = model.estimate(self.latents(b["img"]))
            errs.append(float(((pred - b["state"]) ** 2).mean()))
        return float(np.mean(errs)) if errs else float("inf")

    def run(self, n_iter=None, resume=False):
        """Train from a seeded init (or the latest checkpoint with
        ``resume``) to ``n_iter``; every ``n_iter_eval`` iterations evaluate
        on the valid split and keep the best checkpoint."""
        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        ckpt = CheckpointManager(os.path.join(cfg.save_path, "checkpoints", cfg.name))
        logger = Logger(os.path.join(cfg.save_path, "logs", cfg.name))
        self.model.init(seed=cfg.seed)
        state = self.init_state(self.model)
        start = 0
        if resume:
            state = ckpt.load("state", "latest", target=state)
            start = state.step
        train_ds = create_dataset(cfg.data, phase="train", load_vid=False)
        valid_ds = create_dataset(cfg.data, phase="valid", load_vid=False)
        loader = PrefetchLoader(train_ds, cfg.data.batch_size_img,
                                num_workers=cfg.data.num_workers)
        vloader = PrefetchLoader(valid_ds, cfg.data.batch_size_img, shuffle=False,
                                 num_workers=cfg.data.num_workers)
        it_data = iter(cycle_loader(loader))
        best = ckpt.best_metric("state") if resume else float("inf")
        self.preempted = False
        with PreemptionGuard() as guard:
            for it in range(start, n_iter):
                state, m = self.step(state, to_device(next(it_data), self.device))
                logger.log_scalars(m, it, prefix="state/")
                if cfg.n_iter_eval and it % cfg.n_iter_eval == 0 and it > 0:
                    err = self.evaluate(state.params, vloader)
                    logger.log_scalar("state/eval_mse", err, it)
                    if err < best:
                        best = err
                        ckpt.save("state", it, state.state_dict(), best=True)
                        ckpt.record_best("state", it, err)
                if it % cfg.save_latest_freq == 0 and it > 0:
                    ckpt.save("state", it, state.state_dict(), latest=True)
                if guard.triggered:
                    ckpt.save("state", it + 1, state.state_dict(), latest=True)
                    self.preempted = True
                    break
        if not self.preempted:
            ckpt.save("state", n_iter, state.state_dict(), latest=True)
        logger.close()
        return state


class StftAutoencoderTrainer:
    """``helpers/stft_autoencoder_trainer.py:17-151``: trains the
    :class:`StftModel` of ``cfg.stft`` (fp32) with Adam on the clips'
    spectrogram patches (``batch["stft"]``, from ``extra_data`` when set),
    MSE + VQ + the perceptual loss of VGG19 (``vgg_npz``, or seeded random
    filters), on ``device`` (default: the GPU). K1 once a step on CUDA."""

    def __init__(self, cfg, vgg_npz=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = StftModel(cfg.stft, device=self.device)
        self.vgg = make_vgg(vgg_npz, seed=cfg.seed, device=self.device,
                            context="the STFT perceptual loss")
        s = cfg.stft
        self.init_state, self.step = make_simple_step(
            self.loss_fn, lambda m: make_adam(m.parameters(), s.lr, s.beta1, s.beta2,
                                              s.weight_decay))
        self.preempted = False

    def loss_fn(self, model, batch):
        return model.loss(batch["stft"].reshape(-1, 64, 16, 1), self.vgg)

    def make_loader(self):
        vid_src = self.cfg.extra_data if self.cfg.extra_data is not None else self.cfg.data
        ds = create_dataset(vid_src, phase="train", load_vid=True)
        return PrefetchLoader(ds, vid_src.batch_size_vid, num_workers=vid_src.num_workers)

    def run(self, n_iter=None, resume=False):
        """Train from a seeded init (or the latest checkpoint with
        ``resume``) to ``n_iter``; every ``n_iter_eval`` iterations keep the
        best checkpoint by the step's MSE; with ``cfg.npz_mirror`` the
        model into that npz as the JAX package's ``stft`` tree."""
        from ccvs_tpu_torch.weights import export_params

        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        mirror = None
        if cfg.npz_mirror:
            mirror = (cfg.npz_mirror, lambda tree: {"stft": export_params(self.model)})
        ckpt = CheckpointManager(os.path.join(cfg.save_path, "checkpoints", cfg.name),
                                 npz_mirror=mirror)
        logger = Logger(os.path.join(cfg.save_path, "logs", cfg.name))
        self.model.init(seed=cfg.seed)
        state = self.init_state(self.model)
        start = 0
        if resume:
            state = ckpt.load("stft", "latest", target=state)
            start = state.step
        it_data = iter(cycle_loader(self.make_loader()))
        best = ckpt.best_metric("stft") if resume else float("inf")
        self.preempted = False
        with PreemptionGuard() as guard:
            for it in range(start, n_iter):
                state, m = self.step(state, to_device(next(it_data), self.device))
                logger.log_scalars(m, it, prefix="stft/")
                if cfg.n_iter_eval and it % cfg.n_iter_eval == 0 and it > 0:
                    mse = float(m["stft_mse"])
                    if mse < best:
                        best = mse
                        ckpt.save("stft", it, state.state_dict(), best=True)
                        ckpt.record_best("stft", it, mse)
                if it % cfg.save_latest_freq == 0 and it > 0:
                    ckpt.save("stft", it, state.state_dict(), latest=True)
                if guard.triggered:
                    ckpt.save("stft", it + 1, state.state_dict(), latest=True)
                    self.preempted = True
                    break
        if not self.preempted:
            ckpt.save("stft", n_iter, state.state_dict(), latest=True)
        logger.close()
        return state
