"""Latent-transformer training (counterpart of
``ccvs_tpu/train/transformer_trainer.py``): the frozen autoencoder (and
state or STFT model) encodes each video batch to tokens, the conditioning is
assembled (state, audio, point-to-point, class labels, deblurring), and the
GPT takes AdamW steps with fp32 master weights under bf16 compute.
:func:`blur_video`, the deblurring mode's blur, is shared with serving.

With ``mesh`` the trainer runs data-parallel (``train/ae_trainer.py``); on
a model axis of more than one it splits the GPT's weights over it
(``parallel/tp.py``) and with ``cfg.gpt.seq_parallel`` the tokens too
(``parallel/sp.py``), with ``cfg.gpt.fsdp`` its parameters and moments over
the data axis (``parallel/fsdp.py``); rank 0 writes the checkpoints whole,
in the format one process writes.
"""

import os
import time

import torch
import torch.nn.functional as F

from ccvs_tpu_torch.data import PrefetchLoader, create_dataset
from ccvs_tpu_torch.models.transformer import TokenTransformer
from ccvs_tpu_torch.parallel.fsdp import full_train_state, load_full_train_state
from ccvs_tpu_torch.parallel.mesh import replicate_tree
from ccvs_tpu_torch.parallel.tp import shard_gpt_params
from ccvs_tpu_torch.train.ae_trainer import (cycle_loader, host_shard, is_main_process,
                                             to_device, trainer_device)
from ccvs_tpu_torch.train.steps import make_transformer_step
from ccvs_tpu_torch.utils import profiling
from ccvs_tpu_torch.utils.checkpoint import CheckpointManager
from ccvs_tpu_torch.utils.logging import Logger
from ccvs_tpu_torch.utils.preemption import PreemptionGuard
from ccvs_tpu_torch.weights import export_params

# frames a pass of the frozen encoder: a pass keeps every resolution's
# features alive, ~60 MB a frame at 256x256 with the fp32 blur of the first
# resolution, so the 256 frames of a full-width BAIR batch in one pass need
# ~15-25 GB beside the GPT step's activations and fragment the allocator's
# pool until an 8 GB buffer no longer fits on an 80 GB card
ENCODE_FRAMES = 32


def _reflect_index(n, radius, device):
    """Source indices of a length-``n`` axis padded by ``radius`` on both
    sides in scipy's ``"reflect"`` mode (``d c b a | a b c d | d c b a``, the
    edge sample repeated; torch's ``"reflect"`` padding is scipy's
    ``"mirror"``), for any ``radius``: the padded axis repeats with period
    ``2 n``."""
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def blur_video(vid, sigma):
    """Gaussian blur of each frame and channel of ``vid`` ``(B, T, H, W, C)``
    on its device: ``scipy.ndimage.gaussian_filter(frame, sigma,
    truncate=1.5)`` in mode ``"reflect"``, as the JAX package computes it on
    the host. Two separable 1-D convolutions of radius ``int(1.5 * sigma +
    0.5)``, in fp32; returns ``vid``'s dtype."""
    b, t, h, w, c = vid.shape
    radius = int(1.5 * sigma + 0.5)
    dev = vid.device
    x = torch.arange(-radius, radius + 1, dtype=torch.float64, device=dev)
    k = torch.exp(-0.5 / (sigma * sigma) * x * x)
    k = (k / k.sum()).float()
    frames = vid.permute(0, 1, 4, 2, 3).reshape(-1, 1, h, w).float()
    frames = frames.index_select(2, _reflect_index(h, radius, dev))
    frames = F.conv2d(frames, k.view(1, 1, -1, 1))
    frames = frames.index_select(3, _reflect_index(w, radius, dev))
    frames = F.conv2d(frames, k.view(1, 1, 1, -1))
    return frames.reshape(b, t, c, h, w).permute(0, 1, 3, 4, 2).to(vid.dtype)


class TransformerTrainer:
    """Trains the GPT of ``cfg.gpt`` on the tokens of the frozen autoencoder
    ``ae`` (and ``state_model`` for state conditioning, ``stft_model`` for
    audio), all on ``device`` (default: the GPU). The GPT computes in
    ``dtype`` and holds fp32 parameters, as the JAX package's
    ``TransformerTrainer(dtype=jnp.bfloat16)`` does."""

    def __init__(self, cfg, ae, state_model=None, stft_model=None, dtype=torch.bfloat16,
                 device=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = trainer_device(device, mesh)
        for m in (ae, state_model, stft_model):
            if m is not None and m.device != self.device:
                raise ValueError(f"a model is on {m.device}, the trainer on {self.device}")
        self.ae = ae
        self.transformer = TokenTransformer(cfg.gpt, dtype=dtype, device=self.device,
                                            param_dtype=torch.float32)
        self.state_model = state_model if cfg.gpt.state and not cfg.gpt.stft else None
        self.stft_model = stft_model if cfg.gpt.stft else None
        self.init_state, self.step = make_transformer_step(self.transformer, cfg.gpt, cfg.n_iter,
                                                           mesh=mesh)
        self.preempted = False

    @torch.no_grad()
    def encode(self, vid):
        """Clips ``(B, T, H, W, 3)`` -> token codes ``(B, T, h*w)``, those of
        ``ae.encode``: the frozen encoder over ``ENCODE_FRAMES`` frames a
        pass, then one nearest-code search over all the latents (one K1
        launch on CUDA)."""
        b, t = vid.shape[:2]
        frames = vid.reshape(b * t, *vid.shape[2:]).to(self.ae.dtype)
        z = torch.cat([self.ae.encoder(f)[0] for f in frames.split(ENCODE_FRAMES)])
        _, idx = self.ae.quantizer.quantize(z.float())
        return idx.reshape(b, t, -1)

    @torch.no_grad()
    def encode_layout(self, layout):
        """Layouts ``(B, T, H, W)`` -> layout token codes ``(B, T * h*w)``,
        those of ``ae.encode_layout``: the layout encoder over
        ``ENCODE_FRAMES`` frames a pass, then one K1 launch over all the
        latents."""
        b, t = layout.shape[:2]
        ae = self.ae
        frames = layout.reshape(b * t, *layout.shape[2:])
        zl = torch.cat([ae.encoder_l(ae.one_hot_layout(f).to(ae.dtype))[0]
                        for f in frames.split(ENCODE_FRAMES)])
        _, idx = ae.quantizer_l.quantize(zl.float())
        return idx.reshape(b, -1)

    @torch.no_grad()
    @profiling.spanned("train.encode", is_root=True)
    def encode_batch(self, batch) -> dict:
        """Video batch (tensors on the device) -> token batch with its
        conditioning (``helpers/transformer_trainer.py:56-81``)."""
        gcfg = self.cfg.gpt
        vid = batch["vid"]
        b = vid.shape[0]
        frame_code = self.encode(vid)
        code = frame_code.reshape(b, -1)
        out = {"code": code}
        if self.state_model is not None:
            out["state_code"] = self.state_model.encode(z=self.ae.embed_code(frame_code))
        if self.stft_model is not None and "stft" in batch:
            out["state_code"] = self.stft_model.encode(batch["stft"])
        if gcfg.layout and "layout" in batch:
            # layout tokens are the control stream (``quantized_video_model.py:801-819``)
            out["state_code"] = self.encode_layout(batch["layout"])
        if gcfg.p2p:
            out["cond_code"] = code[:, -gcfg.z_chunk:]
            out["code"] = code[:, :-gcfg.z_chunk]
            out["delta"] = batch["delta_length"]
        if gcfg.cat:
            out["vid_lbl"] = batch.get("vid_lbl", torch.zeros(b, dtype=torch.long,
                                                              device=vid.device))
        if gcfg.deblurring:
            blurred = blur_video(vid, gcfg.blur_sigma)
            out["state_code"] = self.encode(blurred).reshape(b, -1)
        return out

    def run(self, n_iter=None, resume=False, serialize_steps=False):
        """Train from a seeded init (or, with ``resume``, from the latest
        checkpoint) to ``n_iter`` (default ``cfg.n_iter``): scalars to
        ``logs/<name>/metrics.jsonl``, a latest checkpoint every
        ``save_latest_freq`` iterations and at the end (and on SIGTERM, which
        sets ``self.preempted``), with ``cfg.npz_mirror`` the GPT's
        parameters into that npz in the JAX package's layout.
        ``serialize_steps`` waits for each step's device work before the
        next, so the log's ``t`` stamps time steps."""
        cfg = self.cfg
        n_iter = n_iter or cfg.n_iter
        run_dir = os.path.join(cfg.save_path, "checkpoints", cfg.name)
        main = is_main_process()
        mirror, exported = None, {}
        if cfg.npz_mirror:
            # exported on every rank before the save (a split GPT is gathered)
            mirror = (cfg.npz_mirror, lambda tree: {"gpt": exported["gpt"]})
        ckpt = CheckpointManager(run_dir, async_save=cfg.async_ckpt, npz_mirror=mirror)
        if main:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
        logger = Logger(os.path.join(cfg.save_path, "logs", cfg.name), is_main=main,
                        imagenet_norm=cfg.data.imagenet_norm)

        self.transformer.init(seed=cfg.seed)
        split = False
        if self.mesh is not None:
            replicate_tree(self.mesh, self.transformer)
            if self.mesh["model"].size() > 1:
                # Megatron's split of the weights over the model axis, as the
                # JAX trainer's (the step splits the tokens with seq_parallel)
                shard_gpt_params(self.mesh, self.transformer.model)
            split = cfg.gpt.fsdp or self.mesh["model"].size() > 1
        tstate = self.init_state()
        start = 0
        if resume:
            tree = ckpt.load("transformer", "latest")
            if split:
                load_full_train_state(tstate, tree)
            else:
                tstate.load_state_dict(tree)
            start = tstate.step

        def save(step):
            tree = full_train_state(tstate) if split else tstate.state_dict()
            if cfg.npz_mirror:
                exported["gpt"] = export_params(self.transformer.model)
            if main:
                ckpt.save("transformer", step, tree, latest=True)

        ds = create_dataset(cfg.data, phase="train", load_vid=True)
        loader = PrefetchLoader(ds, cfg.data.batch_size_vid, num_workers=cfg.data.num_workers,
                                seed=cfg.seed, host_shard=host_shard(self.mesh))
        it_data = iter(cycle_loader(loader))

        t0 = time.time()
        self.preempted = False
        with PreemptionGuard() as guard:
            for it in range(start, n_iter):
                tokens = self.encode_batch(to_device(next(it_data), self.device))
                tstate, metrics = self.step(tstate, tokens)
                if serialize_steps and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                logger.log_scalars(metrics, it, prefix="transformer/")
                if cfg.log_freq and it % cfg.log_freq == 0:
                    el = time.time() - t0
                    print(f"iter {it}: nll={float(metrics['nll']):.4f} "
                          f"({el / max(1, it - start + 1):.2f}s/it)")
                if it % cfg.save_latest_freq == 0 and it > start:
                    save(it)
                if guard.sync_triggered():
                    save(it + 1)
                    print(f"[preemption] latest checkpoint written at iter {it + 1}; "
                          "exiting cleanly", flush=True)
                    self.preempted = True
                    break
        if not self.preempted:
            save(n_iter)
        ckpt.wait()
        logger.close()
        return tstate
